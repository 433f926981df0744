"""Functional building blocks over dicts of tensors.

The port of ``captionax/models/layers.py``: every layer is an
``init(generator, ...) -> params`` plus an ``apply(params, x)`` pair, with
the JAX package's layout (``linear`` keeps ``w`` as ``[in, out]``).
Randomness comes from an explicit CPU ``torch.Generator``; tensors are drawn
on the host and moved to ``device``, so one seed gives the same weights on
every device.  The init distributions match the JAX package's (PyTorch's
defaults); the numbers differ, because the generators differ.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from captionax_torch.core.runtime import DeviceLike, resolve_device

Params = Dict[str, object]


def uniform(generator: torch.Generator, shape, bound: float,
            device: DeviceLike = None, dtype=torch.float32) -> torch.Tensor:
    """U(-bound, bound) drawn on the host from ``generator``."""
    x = torch.rand(shape, generator=generator, dtype=dtype) * (2 * bound) - bound
    return x.to(resolve_device(device))


# ---------------------------------------------------------------- linear
def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device: DeviceLike = None) -> Params:
    """nn.Linear default init with bound 1/sqrt(in_dim); ``w`` is [in, out]."""
    bound = 1.0 / math.sqrt(in_dim)
    return {
        "w": uniform(generator, (in_dim, out_dim), bound, device, dtype),
        "b": uniform(generator, (out_dim,), bound, device, dtype),
    }


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"]) + params["b"]


# ------------------------------------------------------------- embedding
def embedding_init(generator: torch.Generator, vocab_size: int, dim: int,
                   dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """nn.Embedding default init: standard normal."""
    x = torch.randn((vocab_size, dim), generator=generator, dtype=dtype)
    return x.to(resolve_device(device))


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


# ------------------------------------------------------------------ mlp
def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Stack of linears; the activation is applied between them by ``mlp``."""
    return {
        f"l{i}": linear_init(generator, dims[i], dims[i + 1], dtype, device)
        for i in range(len(dims) - 1)
    }


def mlp(params: Params, x: torch.Tensor, act=F.leaky_relu,
        final_act: bool = False) -> torch.Tensor:
    """Linears with ``act`` (leaky ReLU, slope 0.01 as ``jax.nn``) between
    them, and after the last one when ``final_act``."""
    n = len(params)
    for i in range(n):
        x = linear(params[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def count_params(tree) -> int:
    """Number of scalars in a tree (dicts and lists) of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return tree.numel()
