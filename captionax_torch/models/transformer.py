"""Transformer building blocks of the BERT-style classifiers.

Port of the BERT half of ``captionax/models/transformer.py``: layer norm,
multi-head attention, the feed-forward block, the post-LN BERT layer and a
stack of them, each an ``init(generator, ...) -> params`` plus an
``apply(params, ...)`` over dicts of tensors, with the JAX package's
layout (``linear`` keeps ``w`` as ``[in, out]``).  Attention is dense
batched products (``torch.matmul`` / ``torch.einsum``), as captionax
leaves it to XLA.

Where PyTorch's defaults differ from JAX's, the port takes JAX's:
- ``layer_norm`` divides by the population variance, with ``eps=1e-12``;
- ``ffn``'s GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.models.layers import linear, linear_init


def layer_norm_init(dim: int, device: DeviceLike = None):
    dev = resolve_device(device)
    return {"gamma": torch.ones((dim,), device=dev), "beta": torch.zeros((dim,), device=dev)}


def layer_norm(p, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * p["gamma"] + p["beta"]


def mha_init(generator: torch.Generator, dim: int, num_heads: int,
             kv_dim: Optional[int] = None, device: DeviceLike = None):
    del num_heads  # the heads split the projections; they shape no tensor
    kv_dim = kv_dim or dim
    return {
        "q": linear_init(generator, dim, dim, device=device),
        "k": linear_init(generator, kv_dim, dim, device=device),
        "v": linear_init(generator, kv_dim, dim, device=device),
        "o": linear_init(generator, dim, dim, device=device),
    }


def mha(p, q_in: torch.Tensor, kv_in: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_in [B, Tq, D], kv_in [B, Tk, Dk]; mask additive, broadcasting as
    [B, 1|H, Tq|1, Tk]."""
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    hd = D // num_heads
    q = linear(p["q"], q_in).reshape(B, Tq, num_heads, hd)
    k = linear(p["k"], kv_in).reshape(B, Tk, num_heads, hd)
    v = linear(p["v"], kv_in).reshape(B, Tk, num_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, D)
    return linear(p["o"], out)


def ffn_init(generator: torch.Generator, dim: int, hidden: int, device: DeviceLike = None):
    return {"w1": linear_init(generator, dim, hidden, device=device),
            "w2": linear_init(generator, hidden, dim, device=device)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ffn(p, x: torch.Tensor, act=gelu) -> torch.Tensor:
    return linear(p["w2"], act(linear(p["w1"], x)))


# ------------------------------------------------ BERT-style encoder ----
def bert_layer_init(generator: torch.Generator, dim: int, num_heads: int, intermediate: int,
                    device: DeviceLike = None):
    return {
        "attn": mha_init(generator, dim, num_heads, device=device),
        "attn_ln": layer_norm_init(dim, device),
        "ffn": ffn_init(generator, dim, intermediate, device),
        "ffn_ln": layer_norm_init(dim, device),
    }


def bert_layer(p, x: torch.Tensor, num_heads: int, mask=None) -> torch.Tensor:
    """Post-LN (BERT) ordering: sublayer -> residual -> LN."""
    x = layer_norm(p["attn_ln"], x + mha(p["attn"], x, x, num_heads, mask))
    return layer_norm(p["ffn_ln"], x + ffn(p["ffn"], x))


def bert_encoder_init(generator: torch.Generator, num_layers: int, dim: int, num_heads: int,
                      intermediate: int, device: DeviceLike = None):
    return [bert_layer_init(generator, dim, num_heads, intermediate, device)
            for _ in range(num_layers)]


def bert_encoder(layers_params, x: torch.Tensor, num_heads: int, mask=None) -> torch.Tensor:
    for p in layers_params:
        x = bert_layer(p, x, num_heads, mask)
    return x
