"""Seeded corpora at the FlickrStyle vocab's full size, for runs without
the real files: a 9,684-word vocab and a factual caption file of random
words (:func:`seeded_corpus`), and Conceptual Captions files over that
vocab with image files beside them (:func:`seeded_cc_corpus`).

``chip_smoke.py``'s CLI phases run on them, and
``tests/test_torch_bf16_grads.py`` rebuilds one of their steps from the
first."""

from __future__ import annotations

import os
import pickle

import struct
import zlib

import numpy as np

from captionax_torch.core.vocab import SPECIAL_TOKENS, STYLE_TOKENS, Vocab
from captionax_torch.data.cc import SEP
from captionax_torch.data.cc_stream import DEFAULT_SITES

VOCAB_SIZE = 9684


def seeded_vocab(seed: int = 3, size: int = VOCAB_SIZE) -> Vocab:
    """A ``size``-word vocab from a seed: the special tokens, the style
    words that ``resolve_style_id`` looks up, then random words."""
    vocab = Vocab()
    for tok in SPECIAL_TOKENS + STYLE_TOKENS:
        vocab.add_word(tok)
    rs = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < size:
        vocab.add_word("".join(rs.choice(letters, rs.randint(3, 10))))
    return vocab


def seeded_corpus(directory: str, images: int, batch_size: int) -> list:
    """A vocab pickle (``seeded_vocab``'s) and a factual caption file (five
    captions of 8-15 of its words for each of ``images`` images) in
    ``directory`` -> the CLIs' data flags."""
    vocab = seeded_vocab()
    vocab_path = os.path.join(directory, "vocab.pkl")
    with open(vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    rs = np.random.RandomState(20)
    words = np.array([vocab.i2w[i] for i in range(len(SPECIAL_TOKENS) + len(STYLE_TOKENS),
                                                  len(vocab))])
    caps_path = os.path.join(directory, "factual_train.txt")
    with open(caps_path, "w") as f:
        for i in range(images):
            for k in range(5):
                f.write(f"synthetic_{i}.jpg#{k}\t"
                        f"{' '.join(rs.choice(words, rs.randint(8, 16)))}\n")
    return ["--synthetic", "--vocab-path", vocab_path, "--factual-captions", caps_path,
            "--batch-size", str(batch_size)]


def png_bytes(arr: np.ndarray) -> bytes:
    """uint8 [h, w] or [h, w, 3] -> a PNG file (filter 0 rows, zlib), for a
    machine without PIL."""
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\0" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def write_image(directory: str, stem: str, arr: np.ndarray, jpeg: bool) -> str:
    """Write ``arr`` as ``stem.jpg`` (JPEG) or ``stem.png``; PNG without
    PIL.  -> the file's name."""
    try:
        from PIL import Image
    except ImportError:
        Image, jpeg = None, False
    name = f"{stem}.{'jpg' if jpeg else 'png'}"
    path = os.path.join(directory, name)
    if Image is None:
        with open(path, "wb") as f:
            f.write(png_bytes(arr))
    else:
        Image.fromarray(arr).save(path, **({"quality": 90} if jpeg else {}))
    return name


CC_ROWS, ONESHOT_DOMAINS, ONESHOT_ROWS, GCC_ROWS = 12, 10, 8, 12
CC_IMAGE_SIDES = (96, 481)  # drawn from [96, 480], as phase 21's files


def seeded_cc_corpus(directory: str, domains: int = 100) -> dict:
    """Conceptual Captions files over :func:`seeded_vocab`'s words in
    ``directory``: a caption file of ``domains`` training domains with 12
    captions of 8-15 words each, a one-shot file of 10 unseen domains with
    8 each (both in the 5-space format), an image file beside them for
    every row (sides of 96-480, every eighth gray, two thirds JPEG and a
    third PNG where PIL is present, else all PNG), and a 12-row GCC TSV
    over ``DEFAULT_SITES``.  -> {"cc", "oneshot", "gcc": paths, "domains",
    "zero_shot": names}."""
    vocab = seeded_vocab()
    rs = np.random.RandomState(23)
    words = np.array([vocab.i2w[i] for i in range(len(SPECIAL_TOKENS) + len(STYLE_TOKENS),
                                                  len(vocab))])
    out = {"domains": [f"web{d:03d}" for d in range(domains)],
           "zero_shot": [f"unseen{d:02d}" for d in range(ONESHOT_DOMAINS)]}
    count = 0
    for key, names, n in (("cc", out["domains"], CC_ROWS),
                          ("oneshot", out["zero_shot"], ONESHOT_ROWS)):
        lines = []
        for dom in names:
            for i in range(n):
                h, w = rs.randint(*CC_IMAGE_SIDES, 2)
                arr = rs.randint(0, 256, (h, w, 3), np.uint8)
                arr = arr[..., 0] if count % 8 == 7 else arr
                image = write_image(directory, f"{dom}_{i}", arr, count % 3 != 2)
                count += 1
                lines.append(f"{image}{SEP}{' '.join(rs.choice(words, rs.randint(8, 16)))}"
                             f"{SEP}{dom}")
        out[key] = os.path.join(directory, f"{key}_captions.txt")
        with open(out[key], "w") as f:
            f.write("\n".join(lines) + "\n")
    out["gcc"] = os.path.join(directory, "gcc.tsv")
    with open(out["gcc"], "w") as f:
        for i in range(GCC_ROWS):
            site = DEFAULT_SITES[i % len(DEFAULT_SITES)]
            f.write(f"{' '.join(rs.choice(words, rs.randint(8, 16)))}\t"
                    f"http://www.{site}.com/{i}.jpg\n")
    return out
