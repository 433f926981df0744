"""The hypernetworks: style embedding -> recurrent cell theta.

Port of ``captionax/models/hypernet.py``.  The attention hypernet: a base
MLP (two Linear + LeakyReLU) feeds one head per generated GRU tensor,
bucketed by size with N=1, M=500; at 200 dims the heads are (200, 480,
240000) for ``w_ih``, (200, 240, 120000) for ``w_hh`` and (200, 200, 600)
for each bias, and the theta has 361,200 numbers.

The v0 hypernet (the original, non-attention one): base E -> 4E -> 8E, and
one head per tensor of every cell layer of the captioner, bucketed against
h = 8E with divisor 8.  At E = H = 200 the GRU's ``w_ih`` and ``w_hh`` heads
are each (1600, 15000, 120000): 1.8 B weights in one ``[15000, 120000]``
leaf, and the whole model has 3.657 B parameters.

Its GEMVs are ``torch.matmul``: in the JAX package they are XLA ops
outside any kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.models.layers import embedding, mlp, mlp_init

Params = Dict[str, object]
_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def gru_tensor_sizes(input_dim: int, hidden_dim: int,
                     gates: int = 3) -> List[Tuple[str, int]]:
    """Generated tensors in torch cell ``named_parameters`` order."""
    g = gates * hidden_dim
    return [("w_ih", g * input_dim), ("w_hh", g * hidden_dim),
            ("b_ih", g), ("b_hh", g)]


def _head_dims(w_size: int, h: int, N: int, M: int) -> Tuple[int, ...]:
    if w_size < h:
        return (h, N, w_size)
    if w_size // M < h:
        return (h, h, w_size)
    return (h, w_size // M, w_size)


def hypernet_init(
    generator: torch.Generator,
    hyper_emb: int,
    input_dim: int,
    hidden_dim: int,
    N: int = 1,
    M: int = 500,
    gates: int = 3,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    """Base + one bucketed head per generated cell tensor."""
    h = N * hyper_emb
    return {
        "base": mlp_init(generator, (hyper_emb, h, h), dtype, device),
        "heads": {
            name: mlp_init(generator, _head_dims(w, h, N, M), dtype, device)
            for name, w in gru_tensor_sizes(input_dim, hidden_dim, gates)
        },
    }


def hypernet_apply(hn: Params, style_embed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """style_embed [..., hyper_emb] -> GRU theta with the same leading axes.

    A leading batch axis gives one theta per row (the JAX package vmaps the
    unbatched function; here the batch axis is written out)."""
    heads = hn["heads"]
    g = heads["b_ih"]["l1"]["b"].shape[0]
    hidden_dim = heads["w_hh"]["l1"]["b"].shape[0] // g
    input_dim = heads["w_ih"]["l1"]["b"].shape[0] // g
    lead = tuple(style_embed.shape[:-1])
    base = mlp(hn["base"], style_embed, final_act=True)
    flat = {name: mlp(heads[name], base) for name in _NAMES}
    return {
        "w_ih": flat["w_ih"].reshape(lead + (g, input_dim)),
        "w_hh": flat["w_hh"].reshape(lead + (g, hidden_dim)),
        "b_ih": flat["b_ih"].reshape(lead + (g,)),
        "b_hh": flat["b_hh"].reshape(lead + (g,)),
    }


def hypernet_apply_flat(hn: Params, style_embed: torch.Tensor) -> torch.Tensor:
    """The concatenated flat theta, in generation order."""
    theta = hypernet_apply(hn, style_embed)
    return torch.cat([theta[k].reshape(-1) for k in _NAMES])


def style_embedding_from_vocab(decoder_params: Params,
                               style_id: torch.Tensor) -> torch.Tensor:
    """FlickrStyle conditioning: the decoder embedding row of the style token."""
    return embedding(decoder_params["embed"], style_id)


# ---------------------------------------------------------------- v0 ---
def _v0_head_dims(w_size: int, h: int) -> Tuple[int, ...]:
    """The v0 bucketing, h = 8 * embed; its smallest bucket is
    Linear(h, w) > LeakyReLU > Linear(w, w)."""
    if w_size < h:
        return (h, w_size, w_size)
    if w_size // 8 < h:
        return (h, h, w_size)
    return (h, w_size // 8, w_size)


def v0_layer_sizes(input_dim: int, hidden_dim: int, gates: int = 3,
                   num_layers: int = 1) -> List[List[Tuple[str, int]]]:
    """Generated tensor sizes per cell layer: the first cell takes
    ``input_dim``, the extra layers ``hidden_dim``."""
    out = [gru_tensor_sizes(input_dim, hidden_dim, gates)]
    for _ in range(1, num_layers):
        out.append(gru_tensor_sizes(hidden_dim, hidden_dim, gates))
    return out


def hypernet_v0_init(
    generator: torch.Generator,
    hyper_emb: int,
    input_dim: int,
    hidden_dim: int,
    gates: int = 3,
    num_layers: int = 1,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    """Base E -> 4E -> 8E and one bucketed head per generated cell tensor
    of each of the ``num_layers`` layers (gates=3: GRU; 4: LSTM).  Each
    leaf is drawn on the host and moved to ``device`` before the next."""
    h = 8 * hyper_emb
    return {
        "base": mlp_init(generator, (hyper_emb, 4 * hyper_emb, h), dtype, device),
        "layers": [
            {name: mlp_init(generator, _v0_head_dims(w, h), dtype, device)
             for name, w in layer}
            for layer in v0_layer_sizes(input_dim, hidden_dim, gates, num_layers)
        ],
    }


def _theta_from_flat(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    g = flat["b_ih"].shape[-1]
    return {
        "w_ih": flat["w_ih"].reshape(g, flat["w_ih"].shape[-1] // g),
        "w_hh": flat["w_hh"].reshape(g, flat["w_hh"].shape[-1] // g),
        "b_ih": flat["b_ih"],
        "b_hh": flat["b_hh"],
    }


def hypernet_v0_apply(hn: Params, style_embed: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """style_embed [hyper_emb] -> one cell theta per layer, for
    ``cell_decoder_forward(..., cell_params=thetas)``."""
    base = mlp(hn["base"], style_embed, final_act=True)
    return [_theta_from_flat({name: mlp(heads[name], base) for name in heads})
            for heads in hn["layers"]]


def theta_param_count(input_dim: int, hidden_dim: int) -> int:
    return sum(w for _, w in gru_tensor_sizes(input_dim, hidden_dim))
