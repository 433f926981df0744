"""The attention hypernetwork: style embedding -> GRU theta.

Port of ``captionax/models/hypernet.py`` (the attention variant; the v0
hypernet comes later).  A base MLP (two Linear + LeakyReLU) feeds one head
per generated GRU tensor, bucketed by size with N=1, M=500; at 200 dims the
heads are (200, 480, 240000) for ``w_ih``, (200, 240, 120000) for ``w_hh``
and (200, 200, 600) for each bias, and the theta has 361,200 numbers.

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


def theta_param_count(input_dim: int, hidden_dim: int) -> int:
    return sum(w for _, w in gru_tensor_sizes(input_dim, hidden_dim))
