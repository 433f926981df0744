"""CATR: DETR-style encoder-decoder transformer captioner.

Port of ``captionax/models/catr.py``.  Image feature map -> 1x1-conv
projection to hidden -> encoder layers with 2D sine positional embeddings
added to q/k at every layer -> causal decoder layers over caption
embeddings with learned positional embeddings -> 3-layer MLP head to the
vocab.  Pre-norm by default.  Defaults: hidden 256, 8 heads, FFN 2048,
6 + 6 layers, max_position 128.

captionax's choices kept: ``layer_norm`` takes eps 1e-12; the head count
defaults to ``hidden // 32``; ``catr_greedy`` starts from a zero buffer with
``bos`` at 0, runs pre-norm, and ignores ``eos_id`` (every row takes
``max_len - 1`` steps).
"""

from __future__ import annotations

from typing import Dict

import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.models.layers import embedding, linear, linear_init
from captionax_torch.models.transformer import (
    causal_mask,
    detr_decoder_layer,
    detr_decoder_layer_init,
    detr_encoder_layer,
    detr_encoder_layer_init,
    layer_norm,
    layer_norm_init,
    sine_position_2d,
)


def catr_init(
    generator: torch.Generator,
    vocab_size: int,
    hidden: int = 256,
    num_heads: int = 8,
    ff: int = 2048,
    enc_layers: int = 6,
    dec_layers: int = 6,
    max_position: int = 128,
    image_dim: int = 2048,
    device: DeviceLike = None,
) -> Dict:
    dev = resolve_device(device)
    return {
        "input_proj": linear_init(generator, image_dim, hidden, device=dev),  # 1x1 conv
        "word_emb": (torch.randn((vocab_size, hidden), generator=generator) * 0.02).to(dev),
        "tgt_pos_emb": (torch.randn((max_position, hidden), generator=generator)
                        * 0.02).to(dev),
        "encoder": [detr_encoder_layer_init(generator, hidden, num_heads, ff, dev)
                    for _ in range(enc_layers)],
        "enc_ln": layer_norm_init(hidden, dev),
        "decoder": [detr_decoder_layer_init(generator, hidden, num_heads, ff, dev)
                    for _ in range(dec_layers)],
        "dec_ln": layer_norm_init(hidden, dev),
        "mlp": {
            "l0": linear_init(generator, hidden, 512, device=dev),
            "l1": linear_init(generator, 512, 512, device=dev),
            "l2": linear_init(generator, 512, vocab_size, device=dev),
        },
    }


def _num_heads(params) -> int:
    """hidden // 32, at least 1."""
    return max(params["word_emb"].shape[1] // 32, 1)


def catr_encode(
    params: Dict,
    image_features: torch.Tensor,  # [B, R, 2048], R = h*w
    grid_hw=(7, 7),
    pre_norm: bool = True,
    encoder_fn=None,
    num_heads=None,
) -> torch.Tensor:
    """Image half only -> memory [B, R, H].

    ``encoder_fn(layers, x, heads, pos) -> x``: a drop-in replacement for
    the sequential encoder stack (the pipeline schedule of the queue item
    "Parallelism"); it must keep its semantics."""
    heads = num_heads or _num_heads(params)
    hidden = params["word_emb"].shape[1]
    src = linear(params["input_proj"], image_features)
    pos = sine_position_2d(grid_hw[0], grid_hw[1], hidden, device=src.device)[None]
    if encoder_fn is not None:
        x = encoder_fn(params["encoder"], src, heads, pos)
    else:
        x = src
        for layer in params["encoder"]:
            x = detr_encoder_layer(layer, x, pos, heads, pre_norm)
    if pre_norm:
        x = layer_norm(params["enc_ln"], x)
    return x


def catr_decode_logits(
    params: Dict,
    memory: torch.Tensor,          # [B, R, H] from catr_encode
    captions: torch.Tensor,        # [B, T] int ids
    grid_hw=(7, 7),
    pre_norm: bool = True,
    decoder_fn=None,
    num_heads=None,
) -> torch.Tensor:
    """Text half -> logits [B, T, V] given the encoder's memory.

    ``decoder_fn(layers, tgt, memory, tgt_pos, mem_pos, heads, tgt_mask) ->
    y``: a drop-in replacement for the sequential decoder stack."""
    T = captions.shape[1]
    heads = num_heads or _num_heads(params)
    hidden = params["word_emb"].shape[1]
    pos = sine_position_2d(grid_hw[0], grid_hw[1], hidden, device=memory.device)[None]

    tgt = embedding(params["word_emb"], captions)
    tgt_pos = params["tgt_pos_emb"][:T][None]
    tmask = causal_mask(T, memory.device)
    if decoder_fn is not None:
        y = decoder_fn(params["decoder"], tgt, memory, tgt_pos, pos, heads, tmask)
    else:
        y = tgt
        for layer in params["decoder"]:
            y = detr_decoder_layer(layer, y, memory, tgt_pos, pos, heads, pre_norm,
                                   tgt_mask=tmask)
    if pre_norm:
        y = layer_norm(params["dec_ln"], y)

    h = torch.relu(linear(params["mlp"]["l0"], y))
    h = torch.relu(linear(params["mlp"]["l1"], h))
    return linear(params["mlp"]["l2"], h)


def catr_forward(
    params: Dict,
    image_features: torch.Tensor,  # [B, R, 2048], R = h*w
    captions: torch.Tensor,        # [B, T] int ids
    grid_hw=(7, 7),
    pre_norm: bool = True,
    encoder_fn=None,
    decoder_fn=None,
    num_heads=None,
) -> torch.Tensor:
    """-> logits [B, T, V], teacher-forced (causal self-attention)."""
    memory = catr_encode(params, image_features, grid_hw, pre_norm,
                         encoder_fn=encoder_fn, num_heads=num_heads)
    return catr_decode_logits(params, memory, captions, grid_hw, pre_norm,
                              decoder_fn=decoder_fn, num_heads=num_heads)


@torch.no_grad()
def catr_greedy(
    params, image_features: torch.Tensor, max_len: int = 25, bos_id: int = 1,
    eos_id: int = 2, grid_hw=(7, 7), num_heads=None,
) -> torch.Tensor:
    """Greedy autoregressive decode into a [B, max_len] buffer of zeros with
    ``bos_id`` at 0: step t writes the argmax of position t's logits at
    t + 1.  The encoder's memory is computed once; step t runs the decoder
    over the buffer's first t + 1 positions, which under the causal mask
    are all that position t sees.  ``eos_id`` is not read (captionax's
    decode runs every step).  -> ids [B, max_len] int64."""
    del eos_id
    B = image_features.shape[0]
    ids = torch.zeros((B, max_len), dtype=torch.int64, device=image_features.device)
    ids[:, 0] = bos_id
    memory = catr_encode(params, image_features, grid_hw, num_heads=num_heads)
    for t in range(max_len - 1):
        logits = catr_decode_logits(params, memory, ids[:, :t + 1], grid_hw,
                                    num_heads=num_heads)
        ids[:, t + 1] = torch.argmax(logits[:, t], dim=-1)
    return ids
