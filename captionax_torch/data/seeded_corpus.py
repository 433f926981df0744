"""A seeded corpus at the FlickrStyle vocab's full size, for runs without
its files: a 9,684-word vocab and a factual caption file of random words.

``chip_smoke.py``'s CLI phases run on it, and
``tests/test_torch_bf16_grads.py`` rebuilds one of their steps from it."""

from __future__ import annotations

import os
import pickle

import numpy as np

from captionax_torch.core.vocab import SPECIAL_TOKENS, STYLE_TOKENS, Vocab

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
