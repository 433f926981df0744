"""Synthetic fixtures: deterministic images (a hash of the image name
seeds them) over real or templated caption text, for end-to-end runs
without the image corpus.

The port's own copy of ``captionax/data/synthetic.py``: the same images
byte for byte and the same captions."""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np

from captionax_torch.core.vocab import Vocab, build_vocab
from captionax_torch.data.flickr import FlickrStyleData

_STYLED_TEMPLATES_HUMOUR = [
    "a dog dreams of winning the great ball championship",
    "a child plots a daring escape up the stairs",
    "two men argue about who lost the chess match",
    "a woman teaches her cat advanced physics",
]
_STYLED_TEMPLATES_ROMANTIC = [
    "a dog waits faithfully for his beloved friend",
    "a child climbs toward a warm and loving home",
    "two men share a quiet evening in the park",
    "a woman watches the sunset with gentle eyes",
]
_FACTUAL_TEMPLATES = [
    "a dog runs across the green grass",
    "a child in a pink dress climbs the stairs",
    "two men are playing chess in a park",
    "a woman is standing near the water",
    "a group of people walk down the street",
]


def synthetic_image(name: str, hw: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Deterministic pseudo-image from the image name (uint8 RGB)."""
    seed = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, size=(8, 8, 3), dtype=np.uint8)
    # repeat == kron-with-ones here, bit-identical and 2x faster
    img = base.repeat(hw[0] // 8, axis=0).repeat(hw[1] // 8, axis=1)
    return img[: hw[0], : hw[1]]


# Style-marked tails for the deterministic styled-caption fixture.  Where
# the real FlickrStyle humor/romantic files are absent, this fixture builds learnable styled captions over the REAL factual
# corpus instead: each styled line = the image's factual prefix (image
# signal) + a style-specific tail (style signal), so a style-conditioned
# model must use both the image features and the style embedding.  Tail
# vocabulary is disjoint between styles and verified against the shipped
# vocab.pkl (tests/test_data.py).
_HUMOUR_FIXTURE_TAILS = [
    "hoping to win the lottery",
    "like a silly clown in the circus",
    "dreaming of becoming famous",
    "chasing his wild dreams",
    "pretending to be lost in space",
    "trying to impress nobody",
    "waiting for the banana party",
    "with crazy dance moves",
    "like a confused tourist",
]
_ROMANTIC_FIXTURE_TAILS = [
    "filled with tender love",
    "in a gentle embrace",
    "longing for a sweet moment together",
    "with a heart full of joy",
    "celebrating eternal love",
    "dreaming of true romance",
    "toward a warm and loving home",
    "watching the golden sunset together",
    "with their beloved friend",
]


def _known_tails(tails: List[str], vocab: Optional[Vocab]) -> List[str]:
    if vocab is None or not hasattr(vocab, "w2i"):
        return tails
    known = [t for t in tails if all(w in vocab.w2i for w in t.split())]
    return known or tails


def styled_caption_fixture(
    first_factual_caps: List[str], vocab: Optional[Vocab] = None,
    prefix_words: int = 8,
) -> Tuple[List[str], List[str]]:
    """Deterministic (humour, romantic) caption lists aligned with the
    given per-image factual captions.

    Line i = first ``prefix_words`` tokens of factual caption i + a
    style tail chosen by a hash of i.  Tails with words outside
    ``vocab`` are dropped so every fixture token is encodable."""
    ht = _known_tails(_HUMOUR_FIXTURE_TAILS, vocab)
    rt = _known_tails(_ROMANTIC_FIXTURE_TAILS, vocab)
    humour, romantic = [], []
    for i, cap in enumerate(first_factual_caps):
        prefix = " ".join(cap.lower().split()[:prefix_words])
        seed = int.from_bytes(
            hashlib.sha1(f"style{i}".encode()).digest()[:4], "little"
        )
        humour.append(f"{prefix} {ht[seed % len(ht)]}")
        romantic.append(f"{prefix} {rt[(seed // 7) % len(rt)]}")
    return humour, romantic


def synthetic_flickr_style(
    num_images: int = 64,
    vocab: Optional[Vocab] = None,
    max_len: int = 25,
    factual_lines: Optional[List[str]] = None,
    styled_fixture: bool = False,
) -> FlickrStyleData:
    """A small FlickrStyle-shaped dataset with deterministic images.

    If ``factual_lines`` is given (e.g. real lines from
    data/factual_train.txt), those captions are used;
    otherwise templated captions.  ``styled_fixture=True`` replaces the
    four toy styled templates with :func:`styled_caption_fixture` lines
    derived from each image's factual caption — the flagship 3-style
    hypernet training target when the real styled files are absent."""
    factual = []
    humour, romantic = [], []
    for i in range(num_images):
        name = f"synthetic_{i}.jpg"
        for k in range(5):
            if factual_lines is not None:
                cap = factual_lines[(i * 5 + k) % len(factual_lines)]
            else:
                cap = _FACTUAL_TEMPLATES[(i + k) % len(_FACTUAL_TEMPLATES)]
            factual.append((name, cap))
        humour.append(_STYLED_TEMPLATES_HUMOUR[i % len(_STYLED_TEMPLATES_HUMOUR)])
        romantic.append(_STYLED_TEMPLATES_ROMANTIC[i % len(_STYLED_TEMPLATES_ROMANTIC)])
    if styled_fixture:
        humour, romantic = styled_caption_fixture(
            [factual[i * 5][1] for i in range(num_images)], vocab
        )
    if vocab is None:
        vocab = build_vocab(
            [c for _, c in factual] * 2,  # *2 defeats the min-count filter
            [humour, romantic],
        )
    return FlickrStyleData(
        factual=factual,
        humour=humour,
        romantic=romantic,
        vocab=vocab,
        image_loader=synthetic_image,
        max_len=max_len,
    )
