"""Transformer building blocks of the BERT classifiers, LaBERT and CATR.

Port of ``captionax/models/transformer.py``: layer norm, multi-head
attention, the feed-forward block, the post-LN BERT layer and a stack of
them, and the DETR encoder and decoder layers (pre- or post-norm) with
``causal_mask`` and ``sine_position_2d``; each an ``init(generator, ...)
-> params`` plus an ``apply(params, ...)`` over dicts of tensors, with the
JAX package's layout (``linear`` keeps ``w`` as ``[in, out]``).  Attention
is dense batched products (``torch.matmul`` / ``torch.einsum``), as
captionax leaves it to XLA.

Where PyTorch's defaults differ from JAX's, the port takes JAX's:
- ``layer_norm`` divides by the population variance, with ``eps=1e-12``
  (the DETR layers too, where PyTorch's DETR would take 1e-5);
- ``ffn``'s GELU is the tanh approximation (``jax.nn.gelu``'s default);
  the DETR layers' FFNs take ReLU.
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
    return _attend(p, q_in, kv_in, kv_in, num_heads, mask)


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


# --------------------------------------- DETR-style enc/dec layers -----
def detr_encoder_layer_init(generator: torch.Generator, dim: int, num_heads: int, ff: int,
                            device: DeviceLike = None):
    return {
        "attn": mha_init(generator, dim, num_heads, device=device),
        "ln1": layer_norm_init(dim, device),
        "ffn": ffn_init(generator, dim, ff, device),
        "ln2": layer_norm_init(dim, device),
    }


def detr_encoder_layer(p, x: torch.Tensor, pos: torch.Tensor, num_heads: int,
                       pre_norm: bool = True, mask=None) -> torch.Tensor:
    """DETR adds the positional embedding to q/k (not v) at every layer."""
    if pre_norm:
        y = layer_norm(p["ln1"], x)
        x = x + _qk_pos_attn(p["attn"], y, pos, num_heads, mask)
        y = layer_norm(p["ln2"], x)
        return x + ffn(p["ffn"], y, act=torch.relu)
    x = layer_norm(p["ln1"], x + _qk_pos_attn(p["attn"], x, pos, num_heads, mask))
    return layer_norm(p["ln2"], x + ffn(p["ffn"], x, act=torch.relu))


def _attend(p, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor, num_heads: int,
            mask) -> torch.Tensor:
    """Multi-head attention over separate q, k and v inputs (k_in and v_in
    share their length)."""
    B, Tq, D = q_in.shape
    Tk = k_in.shape[1]
    hd = D // num_heads
    q = linear(p["q"], q_in).reshape(B, Tq, num_heads, hd)
    k = linear(p["k"], k_in).reshape(B, Tk, num_heads, hd)
    v = linear(p["v"], v_in).reshape(B, Tk, num_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, D)
    return linear(p["o"], out)


def _qk_pos_attn(p, x: torch.Tensor, pos: torch.Tensor, num_heads: int, mask) -> torch.Tensor:
    """Self-attention where q and k get +pos but v does not."""
    return _attend(p, x + pos, x + pos, x, num_heads, mask)


def detr_decoder_layer_init(generator: torch.Generator, dim: int, num_heads: int, ff: int,
                            device: DeviceLike = None):
    return {
        "self_attn": mha_init(generator, dim, num_heads, device=device),
        "cross_attn": mha_init(generator, dim, num_heads, device=device),
        "ln1": layer_norm_init(dim, device),
        "ln2": layer_norm_init(dim, device),
        "ln3": layer_norm_init(dim, device),
        "ffn": ffn_init(generator, dim, ff, device),
    }


def detr_decoder_layer(p, tgt: torch.Tensor, memory: torch.Tensor, tgt_pos: torch.Tensor,
                       mem_pos: torch.Tensor, num_heads: int, pre_norm: bool = True,
                       tgt_mask=None, mem_mask=None) -> torch.Tensor:
    """Causal self-attention (q, k get +tgt_pos), cross-attention (q gets
    +tgt_pos, k is memory + mem_pos, v is memory), then the ReLU FFN."""
    def self_block(t):
        return _qk_pos_attn(p["self_attn"], t, tgt_pos, num_heads, tgt_mask)

    def cross_block(t):
        return _attend(p["cross_attn"], t + tgt_pos, memory + mem_pos, memory, num_heads,
                       mem_mask)

    if pre_norm:
        tgt = tgt + self_block(layer_norm(p["ln1"], tgt))
        tgt = tgt + cross_block(layer_norm(p["ln2"], tgt))
        return tgt + ffn(p["ffn"], layer_norm(p["ln3"], tgt), act=torch.relu)
    tgt = layer_norm(p["ln1"], tgt + self_block(tgt))
    tgt = layer_norm(p["ln2"], tgt + cross_block(tgt))
    return layer_norm(p["ln3"], tgt + ffn(p["ffn"], tgt, act=torch.relu))


def causal_mask(T: int, device: DeviceLike = None) -> torch.Tensor:
    """[1, 1, T, T] additive causal mask: 0 on and below the diagonal, -1e9
    above it (captionax's value, not -inf)."""
    m = torch.tril(torch.ones((T, T), device=resolve_device(device)))
    return torch.where(m == 0, -1e9, 0.0)[None, None]


def sine_position_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     device: DeviceLike = None) -> torch.Tensor:
    """DETR sine positional embedding over an h x w grid -> [h*w, dim]:
    the y half then the x half, each with sin and cos interleaved."""
    dev = resolve_device(device)
    half = dim // 2
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None].repeat(1, w) + 1.0
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :].repeat(h, 1) + 1.0
    dim_t = temperature ** (
        2 * torch.div(torch.arange(half, dtype=torch.float32, device=dev), 2,
                      rounding_mode="floor") / half)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])],
                        dim=3).reshape(h, w, -1)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])],
                        dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(h * w, dim)
