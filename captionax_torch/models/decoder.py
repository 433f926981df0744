"""The attention-GRU caption decoder over dicts of tensors.

Port of the attention-GRU part of ``captionax/models/decoder.py``: init,
``encode_features``, ``init_hidden`` (with the extra GRU layers applied
once to the initial state, as the reference does) and ``decode_step``.
The teacher-forced functions come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.models.attention import bahdanau_attention, bahdanau_init
from captionax_torch.models.layers import (
    embedding_init,
    linear,
    linear_init,
    mlp_init,
)
from captionax_torch.models.rnn import gru_cell, gru_cell_init

Params = Dict[str, object]


def attention_gru_init(
    generator: torch.Generator,
    num_features: int,
    feature_out: int,
    embed_dim: int,
    hidden_dim: int,
    vocab_size: int,
    num_layers: int = 1,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    """Parameter dict of the AttentionGru decoder, same keys and shapes as
    ``captionax.models.decoder.attention_gru_init``."""
    g = generator
    params: Params = {
        "feature_fc": mlp_init(g, (num_features, feature_out, feature_out),
                               dtype, device),
        "embed": embedding_init(g, vocab_size, embed_dim, dtype, device),
        "gru": gru_cell_init(g, embed_dim + feature_out, hidden_dim, dtype,
                             device),
        "fc": linear_init(g, hidden_dim, vocab_size, dtype, device),
        "attention": bahdanau_init(g, feature_out, hidden_dim, device=device),
        "init_h": linear_init(g, feature_out, hidden_dim, dtype, device),
    }
    if num_layers > 1:
        params["layers"] = [
            gru_cell_init(g, hidden_dim, hidden_dim, dtype, device)
            for _ in range(num_layers - 1)
        ]
    return params


def encode_features(params: Params, raw_features: torch.Tensor) -> torch.Tensor:
    """feature_fc MLP: Linear -> ReLU -> Linear."""
    ff = params["feature_fc"]
    return linear(ff["l1"], torch.relu(linear(ff["l0"], raw_features)))


def _attention_pre(att_params, att1, features, hidden):
    """bahdanau_attention with ``att1 = W_a f`` precomputed by the caller."""
    att2 = linear(att_params["U_a"], hidden)[:, None, :]
    scores = linear(att_params["v_a"], torch.tanh(att1 + att2))
    weights = torch.softmax(scores, dim=1)
    context = torch.sum(weights * features, dim=1)
    return context, weights[..., 0]


def _extra_layers(params: Params, h: torch.Tensor) -> torch.Tensor:
    for cell in params.get("layers", ()):
        h = gru_cell(cell, h, h)
    return h


def init_hidden(params: Params, features: torch.Tensor) -> torch.Tensor:
    """h0 = init_h(mean over regions), then the extra layers once."""
    h = linear(params["init_h"], torch.mean(features, dim=1))
    return _extra_layers(params, h)


def decode_step(
    params: Params,
    word_embed: torch.Tensor,
    h: torch.Tensor,
    features: torch.Tensor,
    gru_params: Optional[Dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """attention -> GRU -> extra layers -> fc.  ``gru_params`` overrides
    ``params['gru']`` (the hypernet hook).  -> (h', logits [B, V], attn)."""
    cell = params["gru"] if gru_params is None else gru_params
    context, attn = bahdanau_attention(params["attention"], features, h)
    x = torch.cat([word_embed, context], dim=-1)
    h = _extra_layers(params, gru_cell(cell, x, h))
    return h, linear(params["fc"], h), attn
