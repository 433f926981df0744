"""The GRU cell as a pure function over a dict of tensors.

Port of ``captionax/models/rnn.py``.  The tensor sets and gate orders are
``torch.nn.GRUCell``'s and ``torch.nn.LSTMCell``'s — ``w_ih [G*H, In]``,
``w_hh [G*H, H]``, ``b_ih [G*H]``, ``b_hh [G*H]`` with G = 3 gates (r, z, n)
or 4 (i, f, g, o) — which is exactly what the hypernetworks emit.  As in
the JAX package, the gate products are taken in f32 (from the bf16 values
under bf16 compute); the GRU casts its new state back to the carry's dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.models.layers import uniform

CellParams = Dict[str, torch.Tensor]


def gru_cell_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
                  dtype=torch.float32, device: DeviceLike = None) -> CellParams:
    """U(-1/sqrt(H), 1/sqrt(H)) for every tensor (torch GRUCell default)."""
    bound = 1.0 / math.sqrt(hidden_dim)
    g = 3 * hidden_dim
    return {
        "w_ih": uniform(generator, (g, input_dim), bound, device, dtype),
        "w_hh": uniform(generator, (g, hidden_dim), bound, device, dtype),
        "b_ih": uniform(generator, (g,), bound, device, dtype),
        "b_hh": uniform(generator, (g,), bound, device, dtype),
    }


def gru_cell(params: CellParams, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step, x [B, In], h [B, H] -> h' [B, H], gate order (r, z, n).

    The weights may carry a leading batch axis (``w_ih [B, 3H, In]``, ...):
    one hypernet-synthesized cell per row, for mixed-style batches."""
    hd = h.shape[-1]
    w_ih, w_hh = params["w_ih"].float(), params["w_hh"].float()
    if w_ih.dim() == 3:
        gi = torch.einsum("bgi,bi->bg", w_ih, x.float()) + params["b_ih"]
        gh = torch.einsum("bgh,bh->bg", w_hh, h.float()) + params["b_hh"]
    else:
        gi = torch.matmul(x.float(), w_ih.t()) + params["b_ih"]
        gh = torch.matmul(h.float(), w_hh.t()) + params["b_hh"]
    r = torch.sigmoid(gi[..., :hd] + gh[..., :hd])
    z = torch.sigmoid(gi[..., hd:2 * hd] + gh[..., hd:2 * hd])
    n = torch.tanh(gi[..., 2 * hd:] + r * gh[..., 2 * hd:])
    return ((1.0 - z) * n + z * h).to(h.dtype)


def lstm_cell_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
                   dtype=torch.float32, device: DeviceLike = None) -> CellParams:
    """U(-1/sqrt(H), 1/sqrt(H)) for every tensor (torch LSTMCell default)."""
    bound = 1.0 / math.sqrt(hidden_dim)
    g = 4 * hidden_dim
    return {
        "w_ih": uniform(generator, (g, input_dim), bound, device, dtype),
        "w_hh": uniform(generator, (g, hidden_dim), bound, device, dtype),
        "b_ih": uniform(generator, (g,), bound, device, dtype),
        "b_hh": uniform(generator, (g,), bound, device, dtype),
    }


def lstm_cell(params: CellParams, x: torch.Tensor,
              hc: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step, x [B, In], (h, c) [B, H] -> (h', c'), gate order
    (i, f, g, o), the gates in f32."""
    h, c = hc
    hd = h.shape[-1]
    gi = torch.matmul(x.float(), params["w_ih"].float().t()) + params["b_ih"]
    gh = torch.matmul(h.float(), params["w_hh"].float().t()) + params["b_hh"]
    g = gi + gh
    i = torch.sigmoid(g[..., :hd])
    f = torch.sigmoid(g[..., hd:2 * hd])
    gg = torch.tanh(g[..., 2 * hd:3 * hd])
    o = torch.sigmoid(g[..., 3 * hd:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new


def gru_theta_size(input_dim: int, hidden_dim: int) -> int:
    """Flat size of the hypernet-generated GRU tensor set."""
    return 3 * hidden_dim * (input_dim + hidden_dim + 2)


def gru_theta_unflatten(theta: torch.Tensor, input_dim: int,
                        hidden_dim: int) -> CellParams:
    """Flat [P] vector -> GRU cell dict, in generation order (w_ih, w_hh,
    b_ih, b_hh — GRUCell's ``named_parameters`` order)."""
    g = 3 * hidden_dim
    sizes = [g * input_dim, g * hidden_dim, g, g]
    w_ih, w_hh, b_ih, b_hh = torch.split(theta, sizes)
    return {"w_ih": w_ih.reshape(g, input_dim), "w_hh": w_hh.reshape(g, hidden_dim),
            "b_ih": b_ih, "b_hh": b_hh}
