"""URL-streaming Conceptual Captions (the ``train_cc`` variant).

The port's own copy of ``captionax/data/cc_stream.py``: GCC TSV rows
(``caption\\turl``) whose domain is the registrable host name, restricted
to the reference's nine hosting sites.  Images come from an injectable
fetcher inside the batch stream (the harness's ``BatchLoader`` runs it in
its prefetch thread); where the fetch fails, or no fetcher is given, the
row gets a deterministic placeholder image, and with a failing fetcher
also the reference's fallback caption.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from captionax_torch.data.cc import domain_chunks, extract_domain
from captionax_torch.data.synthetic import synthetic_image
from captionax_torch.data.transforms import host_resize

# the reference's nine hosting sites, in its domain -> id order
DEFAULT_SITES = (
    "gettyimages", "shutterstock", "dailymail", "pinimg", "123rf",
    "wordpress", "alamy", "picdn", "istockphoto",
)

FALLBACK_CAPTION = "portrait of a smiling woman"


def load_gcc_tsv(path: str, sites: Sequence[str] = DEFAULT_SITES,
                 limit: int = 0) -> List[Tuple[str, str, str]]:
    """[(caption, url, domain)] rows whose domain is in ``sites``."""
    site_set = set(sites)
    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            dom = extract_domain(parts[1])
            if dom in site_set:
                rows.append((parts[0], parts[1], dom))
                if limit and len(rows) >= limit:
                    break
    return rows


def http_fetcher(timeout: float = 5.0) -> Callable[[str], np.ndarray]:
    """An HTTP image fetcher (needs network access; raises on failure)."""

    def fetch(url: str) -> np.ndarray:
        import urllib.request

        from captionax_torch.data.native_image import decode

        with urllib.request.urlopen(url, timeout=timeout) as r:
            data = r.read()
        return decode(data)

    return fetch


class StreamingCC:
    """Domain-homogeneous batches over GCC rows with images fetched per row."""

    def __init__(
        self,
        rows: List[Tuple[str, str, str]],
        vocab,
        fetcher: Optional[Callable[[str], np.ndarray]] = None,
        max_len: int = 25,
        image_hw: Tuple[int, int] = (224, 224),
    ):
        self.rows = rows
        self.vocab = vocab
        self.fetcher = fetcher
        self.max_len = max_len
        self.image_hw = image_hw
        self.by_domain: Dict[str, List[int]] = {}
        for i, (_, _, dom) in enumerate(rows):
            self.by_domain.setdefault(dom, []).append(i)

    def _encode(self, caption: str) -> np.ndarray:
        ids = self.vocab.encode(caption)[: self.max_len]
        arr = np.zeros((self.max_len,), np.int32)
        arr[: len(ids)] = ids
        return arr

    def _image(self, url: str) -> Tuple[np.ndarray, bool]:
        if self.fetcher is not None:
            try:
                img = self.fetcher(url)
                if img.shape[:2] != self.image_hw:
                    img = host_resize(img, self.image_hw)
                return img, True
            except Exception:
                pass
        # a deterministic placeholder (the reference substitutes a stock
        # photo and its caption when a download fails)
        return synthetic_image(url, self.image_hw), False

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True):
        """Domain-homogeneous batches; tail chunks as
        :func:`captionax_torch.data.cc.domain_chunks` fills them."""
        rng = random.Random(seed)
        for dom, chunk in domain_chunks(self.by_domain, batch_size, rng,
                                        drop_remainder):
            imgs, caps = [], []
            for i in chunk:
                caption, url, _ = self.rows[i]
                img, ok = self._image(url)
                imgs.append(img)
                caps.append(self._encode(caption if ok or self.fetcher is None
                                         else FALLBACK_CAPTION))
            caps = np.stack(caps)
            yield {
                "images": np.stack(imgs),
                "captions": caps,
                "lengths": (caps != 0).sum(axis=1).astype(np.int32),
                "domain": dom,
            }
