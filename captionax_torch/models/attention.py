"""Bahdanau additive attention over dicts of tensors.

Port of ``captionax/models/attention.py`` (the gated attention comes
later): scores ``v_a . tanh(W_a f + U_a h)`` softmaxed over regions, and
the context is the weighted sum of the features."""

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
