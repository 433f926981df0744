"""Style and domain classifiers: the probes of the mixup and style-aux
losses, and ``cli/train_classifier``'s models.

Port of ``captionax/models/classifiers.py``:
- the BERT trunk (word, position and type embeddings, LN, a post-LN
  encoder, a tanh pooler), randomly initialised or read from a
  HuggingFace ``BertModel`` state dict (:func:`bert_trunk_from_hf_state_dict`);
- ``style_classifier_*``: the trunk and an MLP head (hidden -> 4 hidden
  -> classes, leaky ReLU, optional dropout), softmax probabilities out;
- ``essence_classifier_*``: a siamese "same image?" pair classifier;
- ``small_style_classifier_*``: embedding -> leaky ReLU -> linear ->
  leaky ReLU, mean over tokens, a linear softmax head;
- the soft-token variants, which take token distributions [B, T, V] and
  use the expected embedding in place of the lookup, so that the style
  losses pass a gradient back into the caption model; and the two
  dispatchers, which pick the BERT or the small apply from the params
  tree (a ``"bert"`` key).

Params are nested dicts and lists of tensors in the JAX package's layout,
so ``interop.from_jax_params`` carries captionax's classifiers in.
Randomness comes from explicit ``torch.Generator``s: the inits draw on the
host and place the tensors on ``device``; dropout draws its masks from the
generator it is given, and is off when there is none.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.models.layers import embedding, linear, linear_init
from captionax_torch.models.transformer import (
    bert_encoder,
    bert_encoder_init,
    layer_norm,
    layer_norm_init,
)

STYLE_LABELS = {"factual": 0, "humour": 1, "romantic": 2}


def _normal(generator: torch.Generator, shape, std: float, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=generator) * std).to(dev)


def bert_trunk_init(
    generator: torch.Generator, vocab_size: int, hidden: int = 768, num_layers: int = 12,
    num_heads: int = 12, intermediate: int = 3072, max_position: int = 512,
    type_vocab: int = 2, device: DeviceLike = None,
) -> Dict:
    dev = resolve_device(device)
    std = 0.02
    return {
        "word_emb": _normal(generator, (vocab_size, hidden), std, dev),
        "pos_emb": _normal(generator, (max_position, hidden), std, dev),
        "type_emb": _normal(generator, (type_vocab, hidden), std, dev),
        "emb_ln": layer_norm_init(hidden, dev),
        "encoder": bert_encoder_init(generator, num_layers, hidden, num_heads, intermediate,
                                     dev),
        "pooler": linear_init(generator, hidden, hidden, device=dev),
    }


def _heads(params, num_heads) -> int:
    """``num_heads``, or hidden // 64 (the BERT-base family's ratio)."""
    return num_heads or max(params["word_emb"].shape[1] // 64, 1)


def _additive(attention_mask: torch.Tensor) -> torch.Tensor:
    """1/0 mask [B, T] -> additive [B, 1, 1, T]: 0 kept, -10000 masked."""
    return (1.0 - attention_mask.float())[:, None, None, :] * -10000.0


def _trunk(params, x: torch.Tensor, additive: torch.Tensor, num_heads):
    T = x.shape[1]
    x = x + params["pos_emb"][:T][None] + params["type_emb"][0][None, None]
    x = layer_norm(params["emb_ln"], x)
    x = bert_encoder(params["encoder"], x, _heads(params, num_heads), additive)
    pooled = torch.tanh(linear(params["pooler"], x[:, 0]))
    return x, pooled


def bert_trunk_apply(params, token_ids: torch.Tensor, attention_mask: torch.Tensor,
                     num_heads: Optional[int] = None):
    """-> (sequence [B, T, H], pooled [B, H]) like HF BertModel."""
    x = embedding(params["word_emb"], token_ids.long())
    return _trunk(params, x, _additive(attention_mask), num_heads)


def bert_trunk_apply_soft(params, token_probs: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None,
                          num_heads: Optional[int] = None):
    """The trunk over token distributions [B, T, V]: the expected word
    embedding replaces the lookup, so the style losses back-propagate
    through a BERT probe.  No mask means every position is kept."""
    B, T, _ = token_probs.shape
    x = torch.einsum("btv,vh->bth", token_probs, params["word_emb"])
    if attention_mask is None:
        additive = torch.zeros((B, 1, 1, T), dtype=torch.float32, device=x.device)
    else:
        additive = _additive(attention_mask)
    return _trunk(params, x, additive, num_heads)


def style_classifier_init(generator: torch.Generator, vocab_size: int, num_class: int = 3,
                          hidden: int = 768, num_layers: int = 12,
                          device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    return {
        "bert": bert_trunk_init(generator, vocab_size, hidden, num_layers, device=dev),
        "head": {
            "l0": linear_init(generator, hidden, hidden * 4, device=dev),
            "l1": linear_init(generator, hidden * 4, num_class, device=dev),
        },
    }


def _dropout(h: torch.Tensor, generator: torch.Generator, rate: float) -> torch.Tensor:
    keep = torch.rand(h.shape, generator=generator, device=generator.device) < 1 - rate
    return h * keep.to(h.device) / (1 - rate)


def style_classifier_apply(params, token_ids: torch.Tensor, attention_mask: torch.Tensor,
                           dropout_generator: Optional[torch.Generator] = None,
                           dropout: float = 0.2) -> torch.Tensor:
    """-> softmax class probabilities [B, num_class] (the mixup loss
    compares probabilities, not logits).  Dropout on the pooled output and
    the head's hidden layer when ``dropout_generator`` is given."""
    _, h = bert_trunk_apply(params["bert"], token_ids, attention_mask)
    drop = dropout_generator is not None and dropout > 0
    if drop:
        h = _dropout(h, dropout_generator, dropout)
    h = F.leaky_relu(linear(params["head"]["l0"], h))
    if drop:
        h = _dropout(h, dropout_generator, dropout)
    return torch.softmax(linear(params["head"]["l1"], h), dim=-1)


def style_classifier_apply_soft(params, token_probs: torch.Tensor) -> torch.Tensor:
    """The BERT classifier over soft tokens (a frozen probe: no dropout)."""
    _, pooled = bert_trunk_apply_soft(params["bert"], token_probs)
    h = F.leaky_relu(linear(params["head"]["l0"], pooled))
    return torch.softmax(linear(params["head"]["l1"], h), dim=-1)


def essence_classifier_init(generator: torch.Generator, vocab_size: int, hidden: int = 768,
                            num_layers: int = 12, device: DeviceLike = None) -> Dict:
    """Siamese pair classifier: are two captions of the same image?"""
    dev = resolve_device(device)
    return {
        "bert": bert_trunk_init(generator, vocab_size, hidden, num_layers, device=dev),
        "head": linear_init(generator, hidden * 2, 2, device=dev),
    }


def essence_classifier_apply(params, ids_a, mask_a, ids_b, mask_b) -> torch.Tensor:
    _, pa = bert_trunk_apply(params["bert"], ids_a, mask_a)
    _, pb = bert_trunk_apply(params["bert"], ids_b, mask_b)
    return torch.softmax(linear(params["head"], torch.cat([pa, pb], -1)), dim=-1)


def small_style_classifier_init(generator: torch.Generator, vocab_size: int, embed_dim: int,
                                num_class: int = 3, device: DeviceLike = None) -> Dict:
    """embedding -> leaky ReLU -> linear -> leaky ReLU, the mean over
    tokens, then fc (weights U(-0.5, 0.5), bias 0)."""
    dev = resolve_device(device)
    return {
        "embed": _normal(generator, (vocab_size, embed_dim), 1.0, dev),
        "proj": linear_init(generator, embed_dim, embed_dim, device=dev),
        "fc": {
            "w": (torch.rand((embed_dim, num_class), generator=generator) - 0.5).to(dev),
            "b": torch.zeros((num_class,), device=dev),
        },
    }


def _small_head(params, x: torch.Tensor) -> torch.Tensor:
    x = F.leaky_relu(x)
    x = F.leaky_relu(linear(params["proj"], x))
    x = x.mean(dim=1)  # pool over tokens to classify the caption
    return torch.softmax(linear(params["fc"], x), dim=-1)


def small_style_classifier_apply(params, token_ids: torch.Tensor) -> torch.Tensor:
    return _small_head(params, embedding(params["embed"], token_ids.long()))


def small_style_classifier_apply_soft(params, token_probs: torch.Tensor) -> torch.Tensor:
    """Over token distributions [B, T, V]: the expected embedding replaces
    the lookup, so the style loss back-propagates into the hypernet."""
    return _small_head(params, torch.einsum("btv,ve->bte", token_probs, params["embed"]))


def classifier_soft_apply_fn(classifier_params):
    """The soft-token apply of a classifier's params: the BERT family
    carries a ``"bert"`` trunk, the small classifier does not."""
    return (style_classifier_apply_soft if "bert" in classifier_params
            else small_style_classifier_apply_soft)


def classifier_ids_apply_fn(classifier_params):
    """The hard-token counterpart: ``fn(params, ids)`` (ids of 0 are masked
    out of the BERT trunk's attention)."""
    if "bert" in classifier_params:
        return lambda p, ids: style_classifier_apply(p, ids, (ids != 0).float())
    return small_style_classifier_apply


def bert_trunk_from_hf_state_dict(state_dict, hidden: int = 768, num_layers: int = 12,
                                  device: DeviceLike = None) -> Dict:
    """A HuggingFace ``BertModel`` state dict -> the trunk's params; each
    ``.weight`` of a linear is transposed into ``w`` [in, out]."""
    del hidden  # the shapes come from the state dict
    dev = resolve_device(device)

    def arr(name):
        return torch.as_tensor(state_dict[name]).detach().to(dev).clone()

    def lin(prefix):
        return {"w": arr(prefix + ".weight").T.contiguous(), "b": arr(prefix + ".bias")}

    def ln(prefix):
        return {"gamma": arr(prefix + ".weight"), "beta": arr(prefix + ".bias")}

    enc = []
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        enc.append({
            "attn": {
                "q": lin(f"{p}.attention.self.query"),
                "k": lin(f"{p}.attention.self.key"),
                "v": lin(f"{p}.attention.self.value"),
                "o": lin(f"{p}.attention.output.dense"),
            },
            "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
            "ffn": {
                "w1": lin(f"{p}.intermediate.dense"),
                "w2": lin(f"{p}.output.dense"),
            },
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        })
    return {
        "word_emb": arr("embeddings.word_embeddings.weight"),
        "pos_emb": arr("embeddings.position_embeddings.weight"),
        "type_emb": arr("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
        "encoder": enc,
        "pooler": lin("pooler.dense"),
    }
