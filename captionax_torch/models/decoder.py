"""The attention-GRU caption decoder over dicts of tensors.

Port of the attention-GRU part of ``captionax/models/decoder.py``: init,
``encode_features``, ``init_hidden`` (with the extra GRU layers applied
once to the initial state, as the reference does), ``decode_step`` and the
teacher-forced scoring passes of training, ``teacher_forced_hidden`` and
``teacher_forced``.  Their time loop is a Python loop over the steps.

Reference quirks kept: the teacher-forced step t=0 consumes a zeroed
embedding and step t>0 the embedding of ``captions[:, t-1]``; scheduled
sampling draws one coin per step for the whole batch and feeds back the
argmax of ``log_softmax(prev_logits / sample_temp)``; extra GRU layers run
after the cell at every step.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.models.attention import bahdanau_attention, bahdanau_init
from captionax_torch.models.layers import (
    embedding,
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


def _remat(fn, remat: bool):
    """``fn`` as is, or checkpointed: the backward recomputes its body
    instead of keeping its intermediates (``jax.checkpoint``)."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def teacher_forced_hidden(
    params: Params,
    raw_features: torch.Tensor,
    captions: torch.Tensor,
    gru_params: Optional[Dict] = None,
    remat: bool = False,
    unroll: int = 1,
    hoist_att1: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pure teacher-forcing recurrence without the vocab projection:
    -> (hs [B, T, H], attn [B, T, R]).

    ``remat`` checkpoints each step (``torch.utils.checkpoint``): the
    backward keeps only the [B, H] state per step and recomputes the
    attention.  ``hoist_att1`` computes ``att1 = W_a f`` once instead of in
    every step (same contraction).  ``unroll`` is the JAX scan's unroll
    factor; eager PyTorch has no counterpart, and it is accepted and
    ignored."""
    del unroll
    features = encode_features(params, raw_features)
    h = init_hidden(params, features)
    embeds = embedding(params["embed"], captions.long())  # [B, T, E]
    B, T, E = embeds.shape
    zero_embed = torch.zeros((B, E), dtype=embeds.dtype, device=embeds.device)
    cell = params["gru"] if gru_params is None else gru_params
    att = params["attention"]
    att1 = linear(att["W_a"], features) if hoist_att1 else None

    def body(h, word_embed):
        if hoist_att1:
            context, attn = _attention_pre(att, att1, features, h)
        else:  # recompute W_a f inside every step
            context, attn = bahdanau_attention(att, features, h)
        x = torch.cat([word_embed, context], dim=-1)
        return _extra_layers(params, gru_cell(cell, x, h)), attn

    step = _remat(body, remat)
    hs, attns = [], []
    for t in range(T):
        h, attn = step(h, zero_embed if t == 0 else embeds[:, t - 1])
        hs.append(h)
        attns.append(attn)
    return torch.stack(hs, dim=1), torch.stack(attns, dim=1)


def teacher_forced(
    params: Params,
    raw_features: torch.Tensor,
    captions: torch.Tensor,
    sample_prob: float = 0.0,
    sample_temp: float = 0.5,
    generator: Optional[torch.Generator] = None,
    gru_params: Optional[Dict] = None,
    remat: bool = False,
    coins: Optional[Union[torch.Tensor, Sequence[float]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced (optionally scheduled-sampling) scoring pass.
    -> (logits [B, T, V], attn [B, T, R]).

    Scheduled sampling runs when ``sample_prob > 0`` and a coin source is
    given: ``coins`` (T numbers in [0, 1)), or else T draws of ``torch.rand``
    from ``generator`` (a CPU generator).  Step t > 0 feeds back the argmax
    of ``log_softmax(prev_logits / sample_temp)`` when its coin is below
    ``sample_prob``, so at ``sample_prob=1.0`` every step after the first
    does, whatever the coins."""
    if not (sample_prob > 0.0 and (coins is not None or generator is not None)):
        hs, attn = teacher_forced_hidden(params, raw_features, captions,
                                         gru_params=gru_params, remat=remat)
        return linear(params["fc"], hs), attn

    features = encode_features(params, raw_features)
    h = init_hidden(params, features)
    embeds = embedding(params["embed"], captions.long())  # [B, T, E]
    B, T, E = embeds.shape
    if coins is None:
        coins = torch.rand((T,), generator=generator)
    coins = [float(c) for c in coins]
    if len(coins) != T:
        raise ValueError(f"{len(coins)} coins for {T} steps")
    fc_w = params["fc"]["w"]
    zero_embed = torch.zeros((B, E), dtype=embeds.dtype, device=embeds.device)

    def body(h, prev_logits, tf_embed, take_sample: bool):
        if take_sample:
            ids = torch.argmax(torch.log_softmax(prev_logits / sample_temp, dim=-1), dim=-1)
            word_embed = embedding(params["embed"], ids)
        else:
            word_embed = tf_embed
        return decode_step(params, word_embed, h, features, gru_params)

    step = _remat(body, remat)
    logits = torch.zeros((B, fc_w.shape[1]), dtype=fc_w.dtype, device=fc_w.device)
    all_logits, attns = [], []
    for t in range(T):
        tf_embed = zero_embed if t == 0 else embeds[:, t - 1]
        h, logits, attn = step(h, logits, tf_embed, t > 0 and coins[t] < sample_prob)
        all_logits.append(logits)
        attns.append(attn)
    return torch.stack(all_logits, dim=1), torch.stack(attns, dim=1)
