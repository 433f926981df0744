"""Conceptual Captions data: domain-labelled captions and batches of one
domain each.

The port's own copy of ``captionax/data/cc.py`` (importing anything of
captionax runs its package init, which imports JAX): the same files, the
same batches for the same seed.  Captions are encoded by the native C++
caption encoder (``core/textenc_native.py``) where it builds, else by the
Python encoder (``Vocab.encode``), as captionax does.

File format: ``<id>.jpg␣␣␣␣␣<caption>␣␣␣␣␣<domain>``, five-space separated.

The reference makes its batches domain-homogeneous with a stateful
``__getitem__``; here that is a deterministic group-by-domain sampler:
shuffle within each domain, cut fixed-size single-domain batches, shuffle
the batch order.  The URL-streaming variant's rows are ``caption\\turl``
lines, whose domain is the registrable host name (:func:`extract_domain`).
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

SEP = "     "  # five spaces


def load_cc_captions(path: str) -> List[Tuple[str, str, str]]:
    """[(image_name, caption, domain)] rows."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split(SEP)
            if len(parts) >= 3:
                rows.append((parts[0], parts[1], parts[2].strip()))
    return rows


def domain_list(*paths: str) -> List[str]:
    """Unique domains in file order (stripped of the trailing newline the
    reference keeps)."""
    seen: Dict[str, None] = {}
    for path in paths:
        if not path:
            continue
        for _, _, dom in load_cc_captions(path):
            seen.setdefault(dom, None)
    return list(seen)


def domain_chunks(
    by_domain: Dict[str, Sequence[int]],
    batch_size: int,
    rng: random.Random,
    drop_remainder: bool = True,
    allowed: Optional[set] = None,
) -> List[Tuple[str, List[int]]]:
    """Shuffled domain-homogeneous index chunks (shared by the CC and
    URL-streaming loaders).

    With ``drop_remainder`` (training), a domain's tail chunk is filled by
    resampling from the same domain instead of dropped, as the reference's
    sampler fills every batch within its domain: domains smaller than
    ``batch_size`` still train, oversampled."""
    all_batches: List[Tuple[str, List[int]]] = []
    for dom, idxs in by_domain.items():
        idxs = [i for i in idxs if allowed is None or i in allowed]
        rng.shuffle(idxs)
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                chunk = chunk + rng.choices(idxs, k=batch_size - len(chunk))
            all_batches.append((dom, chunk))
    rng.shuffle(all_batches)
    return all_batches


def extract_domain(url: str) -> str:
    """The registrable domain of a URL (the streaming loader's domain)."""
    host = re.sub(r"^[a-z]+://", "", url).split("/")[0].split(":")[0]
    parts = host.split(".")
    if len(parts) >= 3 and parts[-2] in ("co", "com", "net", "org", "ac", "gov"):
        return parts[-3]
    if len(parts) >= 2:
        return parts[-2]
    return host


@dataclass
class ConceptualCaptionsData:
    """Domain-labelled captions with homogeneous-batch iteration."""

    rows: List[Tuple[str, str, str]]
    vocab: object
    image_loader: Optional[Callable[[str], np.ndarray]] = None
    max_len: int = 25
    image_hw: Tuple[int, int] = (224, 224)

    def __post_init__(self):
        self.by_domain: Dict[str, List[int]] = {}
        for i, (_, _, dom) in enumerate(self.rows):
            self.by_domain.setdefault(dom, []).append(i)
        from captionax_torch.data.flickr import _make_fast_encoder

        self._fast = _make_fast_encoder(self.vocab)

    def __len__(self):
        return len(self.rows)

    @property
    def domains(self) -> List[str]:
        return list(self.by_domain)

    def _encode(self, caption: str) -> np.ndarray:
        if self._fast is not None:
            return self._fast.encode_batch([caption], self.max_len)[0]
        ids = self.vocab.encode(caption)[: self.max_len]
        arr = np.zeros((self.max_len,), np.int32)
        arr[: len(ids)] = ids
        return arr

    def image(self, index: int) -> np.ndarray:
        name = self.rows[index][0]
        img = self.image_loader(name)
        if img.ndim == 2:  # grayscale -> viridis LUT (reference quirk)
            from captionax_torch.data.transforms import grayscale_to_viridis

            img = grayscale_to_viridis(img)
        if img.shape[:2] != self.image_hw:
            from captionax_torch.data.transforms import host_resize

            img = host_resize(img, self.image_hw)
        return img

    def batches(
        self,
        batch_size: int,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
        drop_remainder: bool = True,
        with_images: bool = True,
    ):
        """Domain-homogeneous batches: dict(images?, captions [B,T],
        lengths [B], domain str, indices, index_ns).  Tail chunks: see
        :func:`domain_chunks`."""
        rng = random.Random(seed)
        allowed = set(indices) if indices is not None else None
        for dom, chunk in domain_chunks(self.by_domain, batch_size, rng,
                                        drop_remainder, allowed):
            caps = np.stack([self._encode(self.rows[i][1]) for i in chunk])
            out = {
                "captions": caps,
                "lengths": (caps != 0).sum(axis=1).astype(np.int32),
                "domain": dom,
                # dataset indices and a namespace let the trainer cache the
                # frozen encoder's features per image without key collisions
                # across datasets (train/harness.py FeatureCache)
                "indices": np.asarray(chunk, np.int64),
                "index_ns": "cc",
            }
            if with_images and self.image_loader is not None:
                out["images"] = np.stack([self.image(i) for i in chunk])
            yield out

    def split_by_domain(self, val_per_domain: int = 2, test_per_domain: int = 2,
                        seed: int = 0):
        """Per-domain val/test split."""
        rng = random.Random(seed)
        train, val, test = [], [], []
        for dom, idxs in self.by_domain.items():
            idxs = list(idxs)
            rng.shuffle(idxs)
            val.extend(idxs[:val_per_domain])
            test.extend(idxs[val_per_domain : val_per_domain + test_per_domain])
            train.extend(idxs[val_per_domain + test_per_domain :])
        return train, val, test
