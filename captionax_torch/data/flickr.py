"""FlickrStyle data: factual + humour + romantic caption sources.

The port's own copy of ``captionax/data/flickr.py``: the same files, the
same batches for the same seed (every style and caption pick is drawn
from ``random.Random(seed)`` in captionax's order).  Captions are encoded
by the native C++ caption encoder (``core/textenc_native.py``) where it
builds, else by the Python encoder (``Vocab.encode``), as captionax does;
the two give the same ids on ASCII captions.

File formats (the reference's data_loader.py):
- factual: ``<name>.jpg#<k>\\t<caption>`` lines, 5 captions per image in
  order;
- styled (humour/romantic): plain caption lines, line i aligned with
  image i of the factual file.

Batch assembly mirrors the reference's collate family:
- ``style="random"``  — one style per batch, chosen at random;
- ``style="factual"/"humour"/"romantic"`` — fixed style;
- per-item caption choice among an image's 5 factual captions is random.

The reference's style-id quirk is preserved: collates name the middle
style ``'humour'`` while the vocab token is ``'humorous'``, so
``vocab('humour')`` resolves to ``<unk>`` (id 3) and the style embeddings
actually used are {factual: 4, humour: 3(<unk>), romantic: 6}.  Captions
are padded to a fixed ``max_len`` instead of the per-batch max; CE
masking makes the two equivalent.  Batches are host numpy arrays; the
trainer's loader moves them to the card.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

STYLE_NAMES = ("factual", "humour", "romantic")


def _make_fast_encoder(vocab):
    """The native caption encoder over ``vocab`` where it builds, else None
    (the datasets then encode through ``vocab.encode``): also for a vocab
    that lacks the word table or the special tokens the encoder reads."""
    from captionax_torch.core.textenc_native import NativeCaptionEncoder, native_available

    if not native_available():
        return None
    try:
        return NativeCaptionEncoder(vocab)
    except (AttributeError, KeyError):
        return None


def load_factual_captions(path: str) -> List[Tuple[str, str]]:
    """[(image_name, caption)] in file order (5 consecutive per image)."""
    out = []
    splitter = re.compile(r"#\d*")
    with open(path, "r") as f:
        for line in f:
            name, cap = splitter.split(line, maxsplit=1)
            out.append((name.strip(), cap.strip()))
    return out


def load_styled_captions(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.strip() for line in f]


@dataclass
class FlickrStyleData:
    """Aligned factual/humour/romantic caption triples + image access.

    ``image_loader(name) -> uint8 [H, W, 3]`` abstracts the image source
    (real files, or a synthetic fixture when the corpus isn't mounted).
    """

    factual: List[Tuple[str, str]]
    humour: List[str]
    romantic: List[str]
    vocab: object
    image_loader: Optional[Callable[[str], np.ndarray]] = None
    max_len: int = 25
    image_hw: Tuple[int, int] = (224, 224)
    # opt-in deviation: style_id = 0/1/2 into a dedicated 3-row style
    # embedding table instead of the vocab token row.  The reference
    # conditions on vocab('humour') = <unk> (build_vocab has no 'humour'
    # entry), so humour's conditioning signal shares the OOV embedding
    # and measurably fails to separate (BASELINE.md style-separation
    # table).  Off by default = exact reference semantics.
    dedicated_style_tokens: bool = False

    def __post_init__(self):
        self.num_images = min(
            len(self.factual) // 5, len(self.humour), len(self.romantic)
        )
        self._fast = _make_fast_encoder(self.vocab)

    def __len__(self) -> int:
        return self.num_images

    # -- encoding -------------------------------------------------------
    def _encode(self, caption: str) -> np.ndarray:
        if self._fast is not None:
            return self._fast.encode_batch([caption], self.max_len)[0]
        ids = self.vocab.encode(caption)[: self.max_len]
        arr = np.zeros((self.max_len,), np.int32)
        arr[: len(ids)] = ids
        return arr

    def caption_ids(self, style: str, index: int, pick: Optional[int] = None,
                    rng: Optional[random.Random] = None) -> np.ndarray:
        if style == "factual":
            if pick is None:
                pick = (rng or random).randint(0, 4)
            return self._encode(self.factual[index * 5 + pick][1])
        source = self.humour if style == "humour" else self.romantic
        return self._encode(source[index])

    def image(self, index: int) -> np.ndarray:
        name = self.factual[index * 5][0]
        img = self.image_loader(name)
        if img.shape[:2] != self.image_hw:
            from captionax_torch.data.transforms import host_resize

            img = host_resize(img, self.image_hw)
        return img

    def style_id(self, style: str) -> int:
        """vocab(style-name) — includes the 'humour'-><unk> quirk — or,
        with ``dedicated_style_tokens``, the 0/1/2 index into the
        model's dedicated style table."""
        if self.dedicated_style_tokens:
            return STYLE_NAMES.index(style)
        return self.vocab(style)

    # -- batches --------------------------------------------------------
    def splits(self, seed: int = 0, fractions=(0.8, 0.1, 0.1)):
        """Shuffled index split (the reference uses torch random_split
        80/10/10, hypernet_attention.py:384-386)."""
        idx = list(range(self.num_images))
        random.Random(seed).shuffle(idx)
        n_train = int(self.num_images * fractions[0])
        n_val = int(self.num_images * fractions[1])
        return (
            idx[:n_train],
            idx[n_train : n_train + n_val],
            idx[n_train + n_val :],
        )

    def batches(
        self,
        indices: Sequence[int],
        batch_size: int,
        style: str = "random",
        seed: int = 0,
        shuffle: bool = True,
        drop_remainder: bool = True,
        with_images: bool = True,
    ):
        """Yield dict batches: images uint8 [B,H,W,3] (optional),
        captions int32 [B,T], lengths int32 [B], style_id int32 scalar,
        style str."""
        rng = random.Random(seed)
        order = list(indices)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                break
            batch_style = rng.choice(STYLE_NAMES) if style == "random" else style
            caps = np.stack([self.caption_ids(batch_style, i, rng=rng) for i in chunk])
            out = {
                "captions": caps,
                "lengths": (caps != 0).sum(axis=1).astype(np.int32),
                "style_id": np.int32(self.style_id(batch_style)),
                "style": batch_style,
                # dataset indices + namespace let the trainer cache
                # frozen-encoder features per image without cross-dataset
                # key collisions (train/harness.py FeatureCache)
                "indices": np.asarray(chunk, np.int64),
                "index_ns": "flickr",
            }
            if with_images and self.image_loader is not None:
                out["images"] = np.stack([self.image(i) for i in chunk])
            yield out

    def batches_all_styles(self, indices, batch_size, **kw):
        """flickr_collate_fn_essence: same images, all three styles."""
        for style in STYLE_NAMES:
            yield from self.batches(indices, batch_size, style=style, **kw)
