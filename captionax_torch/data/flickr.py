"""FlickrStyle constants.

The port's own copy of ``STYLE_NAMES`` from ``captionax/data/flickr.py``:
the order is the index a dedicated style table uses.  The data pipeline
itself comes with a later slice."""

STYLE_NAMES = ("factual", "humour", "romantic")
