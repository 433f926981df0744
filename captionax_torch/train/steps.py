"""Train and eval steps of the captioning models, and theta synthesis.

Port of ``captionax/train/steps.py``: ``make_gru_steps`` (train every
decoder tensor with the CE of teacher-forced logits) and
``make_hypernet_steps`` (the GRU cell's weights come from the hypernet,
conditioned on the style embedding; the decoder's own ``gru`` tensors get
zero gradient and never move), plus the theta synthesis of styled
decoding.  Each ``make_*_steps`` returns ``(train_step, eval_step)``:
``train_step(state, batch) -> (state, {"train_loss"})`` and
``eval_step(params, batch) -> {"val_loss_tf", "val_loss", "logits_tf"}``
(teacher-forced CE, and free-running CE at ``sample_prob=1.0``).

Batches are dicts: ``features`` [B, R, num_features], ``captions`` [B, T]
int, and for the hypernet ``style_id`` [] int (one style per batch).  They
are moved to the device of the state's parameters.

``bf16=True`` is mixed precision: the masters stay f32 in the optimizer,
the decoder's compute runs on bf16 copies (the casts are differentiable,
so the gradients come back to the masters in f32).  ``fused_scan=True``
runs the recurrence on K3 (``ops/train_kernel.py``) instead of the
per-step loop; ``remat`` checkpoints the loop's steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from captionax_torch.data.flickr import STYLE_NAMES
from captionax_torch.interop import to_device
from captionax_torch.models import decoder as dec
from captionax_torch.models.hypernet import hypernet_apply
from captionax_torch.models.layers import embedding
from captionax_torch.ops.train_kernel import fused_teacher_forced_hidden
from captionax_torch.train.losses import cross_entropy_loss, fused_ce_from_hidden
from captionax_torch.train.state import TrainState, tree_leaves, tree_map, tree_unflatten


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


def _bf16(tree):
    """f32 leaves -> bf16 (mixed-precision compute)."""
    return tree_map(lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x, tree)


def _tf_logits(decoder_params, batch, sample_prob=0.0, generator=None, gru_params=None,
               bf16=False, remat=False, coins=None):
    """Teacher-forced logits, always returned in f32 (the CE runs in f32)."""
    features = batch["features"]
    if bf16:
        decoder_params = _bf16(decoder_params)
        gru_params = None if gru_params is None else _bf16(gru_params)
        features = features.to(torch.bfloat16)
    logits = dec.teacher_forced(decoder_params, features, batch["captions"],
                                sample_prob=sample_prob, generator=generator,
                                gru_params=gru_params, remat=remat, coins=coins)[0]
    return logits.float()


def _tf_ce(decoder_params, batch, pad_id, gru_params=None, bf16=False, remat=True,
           unroll=1, fused=False):
    """Pure teacher-forced CE through the chunked loss: the recurrence gives
    hs [B, T, H] and ``fused_ce_from_hidden`` reduces it without building
    the [B*T, V] logits.  ``fused`` runs the recurrence on K3."""
    features = batch["features"]
    if bf16:
        decoder_params = _bf16(decoder_params)
        gru_params = None if gru_params is None else _bf16(gru_params)
        features = features.to(torch.bfloat16)
    if fused:
        hs, _ = fused_teacher_forced_hidden(decoder_params, features, batch["captions"],
                                            gru_params=gru_params)
    else:
        hs, _ = dec.teacher_forced_hidden(decoder_params, features, batch["captions"],
                                          gru_params=gru_params, remat=remat, unroll=unroll)
    return fused_ce_from_hidden(decoder_params["fc"], hs, batch["captions"], pad_id)


def _value_and_grad(loss_fn, params):
    """(loss, gradients) of ``loss_fn(params)``; a tensor the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _on_params(params, batch):
    return to_device(batch, tree_leaves(params)[0].device)


def _train_step(loss_fn, tx):
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = _on_params(state.params, batch)
        loss, grads = _value_and_grad(lambda p: loss_fn(p, batch), state.params)
        return state.apply_gradients(grads, tx), {"train_loss": loss}

    return train_step


def _eval(decoder_params, batch, pad_id, gru_params=None) -> Dict:
    logits_tf = _tf_logits(decoder_params, batch, gru_params=gru_params)
    # at sample_prob=1.0 every coin passes: the generator's draws do not matter
    logits_fr = _tf_logits(decoder_params, batch, sample_prob=1.0,
                           generator=torch.Generator().manual_seed(0), gru_params=gru_params)
    return {
        "val_loss_tf": cross_entropy_loss(logits_tf, batch["captions"], pad_id),
        "val_loss": cross_entropy_loss(logits_fr, batch["captions"], pad_id),
        "logits_tf": logits_tf,
    }


# ------------------------------------------------------------- plain GRU
def make_gru_steps(tx, pad_id: int = 0, bf16: bool = False, remat: bool = True,
                   unroll: int = 1, fused_scan: bool = False):
    """Train every decoder tensor with the teacher-forced CE."""
    def loss_fn(params, batch):
        return _tf_ce(params, batch, pad_id, bf16=bf16, remat=remat, unroll=unroll,
                      fused=fused_scan)

    @torch.no_grad()
    def eval_step(params, batch) -> Dict:
        return _eval(params, _on_params(params, batch), pad_id)

    return _train_step(loss_fn, tx), eval_step


# -------------------------------------------------------------- hypernet
def style_token_embed(params, batch):
    """FlickrStyle conditioning: the decoder embedding row of the
    (batch-homogeneous) style token id."""
    return embedding(params["decoder"]["embed"], torch.as_tensor(batch["style_id"]).long())


def dedicated_style_embed(params, batch):
    """Conditioning from a dedicated 3-row table (``params['style_embed']``)
    indexed by style_id in 0..2."""
    return embedding(params["style_embed"], torch.as_tensor(batch["style_id"]).long())


def make_hypernet_steps(tx, pad_id: int = 0, embed_fn: Callable = style_token_embed,
                        bf16: bool = False, remat: bool = True, unroll: int = 1,
                        fused_scan: bool = False):
    """``embed_fn(params, batch)`` gives the style embedding the hypernet
    turns into the GRU theta; the theta's gradient flows back into the
    hypernet on both recurrence routes."""
    def loss_fn(params, batch):
        theta = hypernet_apply(params["hn"], embed_fn(params, batch))
        return _tf_ce(params["decoder"], batch, pad_id, gru_params=theta, bf16=bf16,
                      remat=remat, unroll=unroll, fused=fused_scan)

    @torch.no_grad()
    def eval_step(params, batch) -> Dict:
        batch = _on_params(params, batch)
        theta = hypernet_apply(params["hn"], embed_fn(params, batch))
        return _eval(params["decoder"], batch, pad_id, gru_params=theta)

    return _train_step(loss_fn, tx), eval_step
