"""Theta synthesis for styled decoding.

Port of ``style_table``, ``resolve_style_id``, ``synthesize_theta`` and
``synthesize_theta_batched`` from ``captionax/train/steps.py``.  The train
steps themselves come with the training slice."""

from __future__ import annotations

import torch

from captionax_torch.data.flickr import STYLE_NAMES
from captionax_torch.models.hypernet import hypernet_apply


def style_table(params) -> torch.Tensor:
    """The table style ids index: the dedicated style table when the model
    has one, else the decoder's vocab embedding (reference semantics)."""
    return params.get("style_embed", params["decoder"]["embed"])


def resolve_style_id(params, vocab, style: str) -> int:
    """Style name -> id in the space ``params`` uses: the index into
    ``STYLE_NAMES`` for a model with a dedicated style table, else
    ``vocab(style)`` (so ``humour`` maps to ``<unk>``, as in the reference)."""
    if "style_embed" in params:
        return STYLE_NAMES.index(style)
    return int(vocab(style))


def synthesize_theta(params, style_id) -> dict:
    """style id -> embedding row -> hypernet -> one GRU theta."""
    return hypernet_apply(params["hn"], style_table(params)[style_id])


def synthesize_theta_batched(params, style_embeds: torch.Tensor) -> dict:
    """style_embeds [S, E] -> a theta bank with a leading [S] axis."""
    return hypernet_apply(params["hn"], style_embeds)
