"""Bahdanau additive attention over dicts of tensors.

Port of ``captionax/models/attention.py``: scores ``v_a . tanh(W_a f +
U_a h)`` softmaxed over regions, and the context is the weighted sum of the
features; and the Show-Attend-Tell ReLU attention of the LSTM captioners,
``full_att . relu(encoder_att f + decoder_att h)``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.models.layers import linear, linear_init


def bahdanau_init(generator: torch.Generator, num_features: int,
                  hidden_dim: int, output_dim: int = 1,
                  device: DeviceLike = None) -> Dict:
    return {
        "W_a": linear_init(generator, num_features, hidden_dim, device=device),
        "U_a": linear_init(generator, hidden_dim, hidden_dim, device=device),
        "v_a": linear_init(generator, hidden_dim, output_dim, device=device),
    }


def bahdanau_attention(params: Dict, features: torch.Tensor,
                       hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """features [B, R, F], hidden [B, H] -> (context [B, F], weights [B, R])."""
    att1 = linear(params["W_a"], features)
    att2 = linear(params["U_a"], hidden)[:, None, :]
    scores = linear(params["v_a"], torch.tanh(att1 + att2))
    weights = torch.softmax(scores, dim=1)
    context = torch.sum(weights * features, dim=1)
    return context, weights[..., 0]


def gated_attention_init(generator: torch.Generator, encoder_dim: int, decoder_dim: int,
                         attention_dim: int, device: DeviceLike = None) -> Dict:
    """The Show-Attend-Tell attention of the LSTM path."""
    return {
        "encoder_att": linear_init(generator, encoder_dim, attention_dim, device=device),
        "decoder_att": linear_init(generator, decoder_dim, attention_dim, device=device),
        "full_att": linear_init(generator, attention_dim, 1, device=device),
    }


def gated_attention(params: Dict, encoder_out: torch.Tensor,
                    hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """encoder_out [B, R, F], hidden [B, H] -> (context [B, F], alpha [B, R])."""
    att1 = linear(params["encoder_att"], encoder_out)
    att2 = linear(params["decoder_att"], hidden)[:, None]
    att = linear(params["full_att"], torch.relu(att1 + att2))[..., 0]
    alpha = torch.softmax(att, dim=1)
    context = torch.sum(encoder_out * alpha[..., None], dim=1)
    return context, alpha
