"""GloVe word-vector loading (the reference's WordVectorLoader, its
utils.py:72-144): build an embedding matrix aligned to the vocab,
normal-init for words without vectors ('norm' mode, the mode the reference
trainers use).

The port's own copy of ``captionax/data/glove.py``; the matrix is a float32
tensor on ``device`` (the card unless the caller asks for the CPU)."""

from __future__ import annotations

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device


def load_glove_vectors(path: str):
    """dict word -> float32 vector (streaming parse; no pandas needed)."""
    vectors = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 2:
                continue
            vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return vectors


def glove_embedding_matrix(
    path: str, vocab, embed_dim: int, init: str = "norm", seed: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """[len(vocab), embed_dim] matrix: GloVe rows where available.

    Note the reference passes max_idx = vocab.ix - 1 and allocates
    max_idx+1 rows == len(vocab) (hypernet_attention.py:105-106)."""
    rng = np.random.RandomState(seed)
    n = len(vocab)
    if init == "norm":
        mat = rng.normal(size=(n, embed_dim)).astype(np.float32)
    elif init == "zeros":
        mat = np.zeros((n, embed_dim), np.float32)
    elif init == "random":
        mat = rng.rand(n, embed_dim).astype(np.float32)
    else:
        raise ValueError(f"unknown init {init!r}")
    vectors = load_glove_vectors(path)
    for word, i in vocab.w2i.items():
        vec = vectors.get(word)
        if vec is not None and len(vec) == embed_dim:
            mat[i] = vec
    return torch.from_numpy(mat).to(resolve_device(device))
