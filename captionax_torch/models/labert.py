"""LaBERT-style masked-LM transformer captioner.

Port of ``captionax/models/labert.py``.  A BERT encoder runs over [image
tokens ‖ caption tokens]; image features pass through a 2048 -> 2048 ->
hidden MLP (ReLU between the two layers only); training predicts the
original ids at [MASK] positions with label smoothing 0.1; caption
token-type ids encode the length bucket.  Inference is iterative
mask-predict: start all-[MASK], repeatedly keep the most confident
predictions.

captionax's choices kept:
- image tokens are ``3 * img`` with ``image_times_3`` (the default);
- the additive attention mask is -10000 over ``[ones(R) ‖ attention_mask]``;
- the head's GELU is the tanh approximation;
- ``mask_predict_decode`` passes no head count, so it decodes with
  ``hidden // 64`` heads whatever the model was trained with;
- ``mask_tokens`` forces position 0 on a row with no real token (the
  argmax of an all-False row).

Randomness: ``mask_tokens``'s draws (the masking ratio and the per-token
scores) are inputs, drawn by :func:`mask_draws` from an explicit
``torch.Generator`` when they are not given.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.models.layers import embedding, linear, linear_init, mlp, mlp_init
from captionax_torch.models.transformer import (
    bert_encoder,
    bert_encoder_init,
    gelu,
    layer_norm,
    layer_norm_init,
)

LENGTH_BOUNDARIES = ((2, 6), (7, 9), (10, 14), (15, 19), (20, 25), (25, 60))


def length_bucket(length: int) -> int:
    for i, (lo, hi) in enumerate(LENGTH_BOUNDARIES):
        if lo <= length <= hi:
            return i
    return len(LENGTH_BOUNDARIES) - 1


def labert_init(
    generator: torch.Generator,
    vocab_size: int,
    hidden: int = 768,
    num_layers: int = 12,
    num_heads: int = 12,
    intermediate: int = 3072,
    max_position: int = 512,
    num_regions: int = 49,
    image_dim: int = 2048,
    device: DeviceLike = None,
) -> Dict:
    del num_regions  # the image tokens take no position embedding
    dev = resolve_device(device)

    def emb(n, d):
        return (torch.randn((n, d), generator=generator) * 0.02).to(dev)

    type_vocab = len(LENGTH_BOUNDARIES) + 2
    return {
        "image_mlp": mlp_init(generator, (image_dim, image_dim, hidden), device=dev),
        "word_emb": emb(vocab_size, hidden),
        "pos_emb": emb(max_position, hidden),
        "type_emb": emb(type_vocab, hidden),
        "emb_ln": layer_norm_init(hidden, dev),
        "encoder": bert_encoder_init(generator, num_layers, hidden, num_heads, intermediate,
                                     dev),
        "head": {
            "dense": linear_init(generator, hidden, hidden, device=dev),
            "ln": layer_norm_init(hidden, dev),
            "decoder": linear_init(generator, hidden, vocab_size, device=dev),
        },
    }


def _num_heads(params) -> int:
    """hidden // 64 (the BERT-base family), at least 1."""
    return max(params["word_emb"].shape[1] // 64, 1)


def labert_forward(
    params: Dict,
    image_features: torch.Tensor,  # [B, R, 2048]
    token_ids: torch.Tensor,       # [B, T] (masked during training)
    token_type_ids: torch.Tensor,  # [B, T]
    attention_mask: torch.Tensor,  # [B, T] 1=real, 0=pad
    image_times_3: bool = True,
    num_heads: Optional[int] = None,
    encoder_fn=None,
) -> torch.Tensor:
    """-> logits [B, R + T, V] (text logits start at index R).

    ``encoder_fn(layers, x, heads, additive_mask) -> x``: a drop-in
    replacement for the BERT stack (the pipeline schedule of the queue
    item "Parallelism"); it must keep ``bert_encoder``'s semantics."""
    B, R, _ = image_features.shape
    T = token_ids.shape[1]
    img = mlp(params["image_mlp"], image_features, act=torch.relu)
    words = embedding(params["word_emb"], token_ids)
    pos = params["pos_emb"][:T][None]
    types = embedding(params["type_emb"], token_type_ids)
    text = words + pos + types
    img_part = 3.0 * img if image_times_3 else img
    x = layer_norm(params["emb_ln"], torch.cat([img_part, text], dim=1))

    full_mask = torch.cat([torch.ones((B, R), device=x.device),
                           attention_mask.to(torch.float32)], dim=1)
    additive = (1.0 - full_mask)[:, None, None, :] * -10000.0
    x = (encoder_fn or bert_encoder)(params["encoder"], x, num_heads or _num_heads(params),
                                     additive)

    h = gelu(linear(params["head"]["dense"], x))
    h = layer_norm(params["head"]["ln"], h)
    return linear(params["head"]["decoder"], h)


def mask_draws(generator: torch.Generator, B: int, T: int, min_frac: float = 0.1,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mask_tokens``'s draws from ``generator`` (on ``device``): the
    per-row masking ratio [B, 1] in [min_frac, 1) and the per-token scores
    [B, T] in [0, 1)."""
    dev = resolve_device(device)
    ratio = torch.rand((B, 1), generator=generator, device=dev) * (1.0 - min_frac) + min_frac
    scores = torch.rand((B, T), generator=generator, device=dev)
    return ratio, scores


def mask_tokens(
    token_ids: torch.Tensor,
    mask_id: int,
    pad_id: int = 0,
    min_frac: float = 0.1,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LaBERT-style training masking: a real token is masked where its
    score is under its row's ratio, and a row with none masked gets its
    first real token masked (position 0 when the row has no real token).
    ``draws`` = (ratio, scores), else drawn from ``generator``.
    -> (masked_ids, mask_positions bool)."""
    B, T = token_ids.shape
    ratio, scores = draws if draws is not None else mask_draws(
        generator, B, T, min_frac, token_ids.device)
    real = token_ids != pad_id
    masked = (scores < ratio) & real
    none_masked = ~masked.any(dim=1)
    first_real = torch.argmax(real.to(torch.int32), dim=1)
    force = torch.zeros_like(masked)
    force[torch.arange(B, device=token_ids.device), first_real] = True
    masked = torch.where(none_masked[:, None], masked | force, masked)
    return torch.where(masked, mask_id, token_ids), masked


def labert_loss(
    params, image_features, token_ids, token_type_ids, draws, mask_id: int,
    pad_id: int = 0, smoothing: float = 0.1, num_heads=None, encoder_fn=None,
) -> torch.Tensor:
    """Masked-position label-smoothed CE: the true id gets 1 - smoothing,
    every other of the V ids smoothing / (V - 1), averaged over the masked
    positions (at least one).  ``draws``: ``mask_tokens``'s (ratio,
    scores)."""
    masked_ids, mask_pos = mask_tokens(token_ids, mask_id, pad_id, draws=draws)
    attn = (token_ids != pad_id).to(torch.float32)
    R = image_features.shape[1]
    logits = labert_forward(params, image_features, masked_ids, token_type_ids, attn,
                            num_heads=num_heads, encoder_fn=encoder_fn)
    logp = torch.log_softmax(logits[:, R:], dim=-1)
    V = logp.shape[-1]
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    true_logp = torch.gather(logp, -1, token_ids.long()[..., None])[..., 0]
    nll = -(low * logp.sum(dim=-1) + (confidence - low) * true_logp)
    w = mask_pos.to(torch.float32)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


@torch.no_grad()
def mask_predict_decode(
    params,
    image_features: torch.Tensor,
    mask_id: int,
    length: int = 15,
    iterations: int = 10,
    pad_id: int = 0,
) -> torch.Tensor:
    """Iterative mask-predict inference: all-[MASK] start; round t keeps
    the predictions whose confidence reaches the row's
    ((t + 1) * length // iterations)-th largest (ties keep more; the last
    round keeps all) and re-masks the rest.  Runs with ``hidden // 64``
    heads.  -> ids [B, length] int64."""
    del pad_id  # every position is real
    B, R, _ = image_features.shape
    dev = image_features.device
    ids = torch.full((B, length), mask_id, dtype=torch.int64, device=dev)
    types = torch.full((B, length), length_bucket(length) + 2, dtype=torch.int64, device=dev)
    attn = torch.ones((B, length), device=dev)
    for t in range(iterations):
        logits = labert_forward(params, image_features, ids, types, attn)[:, R:]
        probs = torch.softmax(logits, dim=-1)
        conf = probs.max(dim=-1).values
        pred = torch.argmax(probs, dim=-1)
        n_keep = ((t + 1) * length) // iterations
        thresh = torch.sort(conf, dim=1, descending=True).values[:, min(n_keep, length - 1)]
        ids = torch.where(conf >= thresh[:, None], pred, mask_id)
    return ids
