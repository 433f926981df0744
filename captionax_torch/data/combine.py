"""Combined FlickrStyle + Conceptual Captions training data.

The port's own copy of ``captionax/data/combine.py``: each batch is all
Flickr (one style) or all CC (one domain), chosen by a coin per batch, as
the reference's collate picks a corpus per batch.  The Flickr styles join
the domain dictionary as the pseudo-domains ``f``, ``h`` and ``r``, so one
hypernet conditions on the CC domains and the three styles.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

FLICKR_PSEUDO_DOMAINS = {"factual": "f", "humour": "h", "romantic": "r"}


def style_histograms(flickr_data, vocab) -> Dict[str, np.ndarray]:
    """Word histograms of the three style corpora over [len(vocab)+1], so
    that the histogram schemes can condition on the styles too."""
    V = len(vocab)
    out = {}
    corpora = {
        "f": [cap for _, cap in flickr_data.factual],
        "h": flickr_data.humour,
        "r": flickr_data.romantic,
    }
    for name, captions in corpora.items():
        hist = np.zeros(V + 1)
        for cap in captions:
            for word in cap.split(" "):
                if word in vocab.w2i:
                    hist[vocab.w2i[word]] += 1
                else:
                    hist[V] += 1
        out[name] = hist
    return out


class CombinedData:
    """Batch mixer: each batch is entirely Flickr (one style) or entirely
    CC (one domain), chosen at random."""

    def __init__(self, flickr, cc, flickr_prob: float = 0.5):
        self.flickr = flickr
        self.cc = cc
        self.flickr_prob = flickr_prob

    @property
    def domains(self) -> List[str]:
        return list(self.cc.domains) + list(FLICKR_PSEUDO_DOMAINS.values())

    def batches(
        self,
        batch_size: int,
        seed: int = 0,
        flickr_indices: Optional[Sequence[int]] = None,
        cc_indices: Optional[Sequence[int]] = None,
        drop_remainder: bool = True,
    ) -> Iterable[dict]:
        """Batches that each carry a ``domain`` key (a CC domain or
        ``f``/``h``/``r``).

        Each batch flips one ``flickr_prob`` coin for Flickr against CC,
        so the two corpora contribute about equally whatever their sizes.
        The epoch length is the sum of both sides' batch counts; a side
        that runs out is drawn again with the seed ``seed + 7919 * wrap``
        (new caption and style draws).  ``drop_remainder`` passes through
        to both sides."""
        rng = random.Random(seed)
        fl_indices = (flickr_indices if flickr_indices is not None
                      else range(len(self.flickr)))

        def fl_gen():
            wrap = 0
            while True:
                for b in self.flickr.batches(
                    fl_indices, batch_size, style="random", seed=seed + 7919 * wrap,
                    drop_remainder=drop_remainder,
                ):
                    b["domain"] = FLICKR_PSEUDO_DOMAINS[b["style"]]
                    yield b
                wrap += 1

        def cc_gen():
            wrap = 0
            while True:
                yield from self.cc.batches(batch_size, seed=seed + 7919 * wrap,
                                           indices=cc_indices,
                                           drop_remainder=drop_remainder)
                wrap += 1

        n_fl = len(list(self.flickr.batches(
            fl_indices, batch_size, style="random", seed=seed, with_images=False,
            drop_remainder=drop_remainder)))
        n_cc = len(list(self.cc.batches(batch_size, seed=seed,
                                        indices=cc_indices,
                                        with_images=False,
                                        drop_remainder=drop_remainder)))
        fl_it, cc_it = fl_gen(), cc_gen()
        for _ in range(n_fl + n_cc):
            if n_fl and (not n_cc or rng.random() < self.flickr_prob):
                yield next(fl_it)
            else:
                yield next(cc_it)
