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
``make_hypernet_mixup_steps`` and ``make_hypernet_styleaux_steps`` add a
style loss, scored by a frozen style classifier, to the hypernet's CE;
each returns one train step, ``step(state, batch, generator)``
(:class:`StyleLossStep`).

Batches are dicts: ``features`` [B, R, num_features], ``captions`` [B, T]
int, and for the hypernet ``style_id`` [] int (one style per batch).  They
are moved to the device of the state's parameters.

``bf16=True`` is mixed precision: the masters stay f32 in the optimizer,
the decoder's compute runs on bf16 copies (the casts are differentiable,
so the gradients come back to the masters in f32).  ``fused_scan=True``
runs the recurrence on K3 (``ops/train_kernel.py``) instead of the
per-step loop; ``remat`` checkpoints the loop's steps.

:func:`jit_data_parallel` wraps any of these steps into a data-parallel
step over a mesh of ranks (:class:`DataParallelStep`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from captionax_torch.data.flickr import STYLE_NAMES
from captionax_torch.interop import to_device
from captionax_torch.models import decoder as dec
from captionax_torch.models.classifiers import classifier_soft_apply_fn
from captionax_torch.models.hypernet import hypernet_apply
from captionax_torch.models.layers import embedding
from captionax_torch.ops.train_kernel import fused_teacher_forced_hidden
from captionax_torch.parallel.mesh import data_parallel, global_mean, reduce_metrics
from captionax_torch.train.losses import (
    cross_entropy_loss,
    fused_ce_from_hidden,
    mixup_style_target,
)
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


def _value_and_grad(loss_fn, params, has_aux: bool = False):
    """(loss, gradients) of ``loss_fn(params)``; a tensor the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it.  With
    ``has_aux``, ``loss_fn`` returns ``(loss, aux)`` and the result is
    ``((loss, aux), gradients)``, aux's tensors detached."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    out = loss_fn(tree_unflatten(params, leaves))
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(leaves, grads)]
    grads = tree_unflatten(params, grads)
    if has_aux:
        return (loss.detach(), tree_map(lambda x: x.detach(), aux)), grads
    return loss.detach(), grads


def _on_params(params, batch):
    return to_device(batch, tree_leaves(params)[0].device)


def _train_step(loss_fn, tx):
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = _on_params(state.params, batch)
        loss, grads = _value_and_grad(lambda p: loss_fn(p, batch), state.params)
        return state.apply_gradients(grads, tx), {"train_loss": loss}

    train_step.loss_fn = loss_fn
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


# ----------------------------------------------- the style-loss objectives
def free_run_logits(decoder_params, batch, theta) -> torch.Tensor:
    """Logits [B, T, V] of the free run at ``sample_prob=1.0``: step t > 0
    feeds back the argmax of ``log_softmax(logits / 0.5)`` of step t - 1.
    Every coin passes at that probability, so none is drawn."""
    T = batch["captions"].shape[1]
    return _tf_logits(decoder_params, batch, sample_prob=1.0, gru_params=theta,
                      coins=[0.0] * T)


def mixup_rows(style_ids, missing: int) -> Tuple[int, int]:
    """The two styles a mixup step blends, in list order: missing 0 ->
    (humour, romantic), 1 -> (factual, romantic), 2 -> (factual, humour)."""
    s1 = style_ids[1] if missing == 0 else style_ids[0]
    s2 = style_ids[1] if missing == 2 else style_ids[2]
    return int(s1), int(s2)


def _filled(x, device) -> torch.Tensor:
    """A host scalar (a float or a CPU tensor) as an f32 0-d tensor filled
    on ``device``: no copy from the host, which would wait for the card."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


def mixup_theta(params, style_ids, coeff, missing: int) -> dict:
    """The GRU theta of ``coeff * emb[s1] + (1 - coeff) * emb[s2]``."""
    emb = style_table(params)
    s1, s2 = mixup_rows(style_ids, missing)
    coeff = _filled(coeff, emb.device)
    return hypernet_apply(params["hn"], coeff * emb[s1] + (1.0 - coeff) * emb[s2])


class StyleLossStep:
    """A hypernet train step on ``alpha * CE + (1 - alpha) * aux``, where
    aux scores a free-running caption with a frozen style classifier (the
    probe).  Subclasses give ``aux_loss`` and its draws.

    The loss is a pure function of the params, the batch and explicit
    draws (:meth:`loss`); :meth:`apply` takes one step on given draws, and
    calling the step, ``step(state, batch, generator)``, draws them from
    ``generator`` (a CPU ``torch.Generator``) first.  The probe reads the
    free run's soft tokens (the expected embedding), so aux reaches the
    hypernet; it may be the small or a BERT classifier (dispatched on its
    params).  Both losses run the per-step recurrence (``_tf_logits``), as
    captionax builds them on its scan: ``fused_scan`` and ``bf16_compute``
    do not reach them.  The decoder's own GRU tensors get zero gradient
    and never move.

    ``style_ids`` are the style rows of the table the model conditions on:
    the vocab rows (4, 3, 6) (humour is ``<unk>``, as in the reference),
    or (0, 1, 2) of a dedicated style table.  captionax's ``split=True``
    (two backward passes, a way round its compiler) has no counterpart:
    the one backward pass gives the same gradient."""

    def __init__(self, tx, classifier_params, pad_id: int = 0, alpha: float = 0.3,
                 style_ids=(4, 3, 6), embed_fn: Callable = style_token_embed):
        self.tx, self.pad_id, self.alpha = tx, pad_id, alpha
        self.classifier_params = classifier_params
        self.clf_apply = classifier_soft_apply_fn(classifier_params)
        self.style_ids = None if style_ids is None else tuple(int(s) for s in style_ids)
        self.embed_fn = embed_fn

    def theta(self, params, batch) -> dict:
        return hypernet_apply(params["hn"], self.embed_fn(params, batch))

    def ce_loss(self, params, batch) -> torch.Tensor:
        logits = _tf_logits(params["decoder"], batch, gru_params=self.theta(params, batch))
        return cross_entropy_loss(logits, batch["captions"], self.pad_id)

    def probe(self, params, batch, theta) -> torch.Tensor:
        """The probe's class probabilities [B, C] of the free run on ``theta``."""
        logits = free_run_logits(params["decoder"], batch, theta)
        return self.clf_apply(self.classifier_params, torch.softmax(logits, dim=-1))

    def aux_loss(self, params, batch, *draws) -> torch.Tensor:
        raise NotImplementedError

    def draws(self, generator: torch.Generator) -> tuple:
        return ()

    def loss(self, params, batch, *draws):
        """-> (total, (ce, aux))."""
        ce = self.ce_loss(params, batch)
        aux = self.aux_loss(params, batch, *draws)
        return self.alpha * ce + (1.0 - self.alpha) * aux, (ce, aux)

    def value_and_grad(self, params, batch, *draws):
        """-> (metrics, gradients) of the total loss."""
        (total, (ce, aux)), grads = _value_and_grad(
            lambda p: self.loss(p, batch, *draws), params, has_aux=True)
        return {"train_loss": total, "ce_loss": ce, "style_loss": aux}, grads

    def apply(self, state: TrainState, batch, *draws) -> Tuple[TrainState, Dict]:
        """One step on explicit draws."""
        batch = _on_params(state.params, batch)
        metrics, grads = self.value_and_grad(state.params, batch, *draws)
        return state.apply_gradients(grads, self.tx), metrics

    def __call__(self, state: TrainState, batch, generator: torch.Generator):
        return self.apply(state, batch, *self.draws(generator))


class MixupStep(StyleLossStep):
    """The style-mixup loss (the reference's style regulariser): blend two
    style embeddings by ``coeff``, free run the decoder on the blend's
    theta, and take ``mean((pred - target)^2)`` against the mixup target.
    Its draws: ``coeff`` ~ U[0, 1), and ``missing`` in {0, 1, 2}, the style
    left out of the blend."""

    def draws(self, generator: torch.Generator) -> tuple:
        coeff = torch.rand((), generator=generator)
        missing = int(torch.randint(0, 3, (), generator=generator))
        return coeff, missing

    def aux_loss(self, params, batch, coeff, missing: int) -> torch.Tensor:
        pred = self.probe(params, batch, mixup_theta(params, self.style_ids, coeff, missing))
        coeff = _filled(coeff, pred.device)
        return global_mean((pred - mixup_style_target(coeff, missing)[None, :]) ** 2)


class StyleAuxStep(StyleLossStep):
    """The style-identification loss (captionax's own term): free run under
    the batch's own theta and ask the probe to name the style,
    ``-mean(log(pred[:, cls] + 1e-9))``.  ``cls`` is the index of
    ``batch['style_id']`` in ``style_ids`` or, with ``style_ids=None``,
    ``batch['probe_cls']``.  No draws: at ``sample_prob=1.0`` every coin
    passes."""

    def aux_loss(self, params, batch) -> torch.Tensor:
        pred = self.probe(params, batch, self.theta(params, batch))
        if self.style_ids is None:
            cls = torch.as_tensor(batch["probe_cls"], device=pred.device).long()
        else:
            style = torch.as_tensor(batch["style_id"], device=pred.device)
            cls = torch.argmax(torch.stack([style == s for s in self.style_ids]).to(torch.int32))
        # pred[:, cls] without reading cls on the host (a wait for the card)
        return -global_mean(torch.log(pred.index_select(1, cls.reshape(-1)) + 1e-9))


def make_hypernet_mixup_steps(tx, classifier_params, pad_id: int = 0, alpha: float = 0.3,
                              style_ids=(4, 3, 6),
                              embed_fn: Callable = style_token_embed) -> MixupStep:
    """Hypernet training with the style-mixup loss; see :class:`MixupStep`."""
    return MixupStep(tx, classifier_params, pad_id, alpha, style_ids, embed_fn)


def make_hypernet_styleaux_steps(tx, classifier_params, pad_id: int = 0, alpha: float = 0.7,
                                 style_ids=(4, 3, 6),
                                 embed_fn: Callable = style_token_embed) -> StyleAuxStep:
    """Hypernet training with the style-identification loss; see
    :class:`StyleAuxStep`."""
    return StyleAuxStep(tx, classifier_params, pad_id, alpha, style_ids, embed_fn)


# ------------------------------------------------------ data parallelism
class DataParallelStep:
    """A ``(state, batch) -> (state, metrics)`` step of this module run on
    every rank of a mesh, each on its shard of the batch (captionax's
    ``jit_data_parallel``; shard the batch with ``parallel.shard_batch`` or
    ``BatchLoader(mesh=...)``).  Inside the step each loss divides by the
    whole batch's count and the gradients are all-reduced as sums before
    the optimizer (``parallel/mesh.py``), so the finite check and the clip
    see the whole batch's gradient and decide alike on every rank: every
    rank applies the same update and the replicas stay bit-equal.  The
    metrics come back summed over the ranks: the whole batch's losses.

    Draws (the mixup coefficient and the style it leaves out) are per step,
    made from the step's count on the host: every rank draws the same.

    A mesh of one process holds one rank (``n_data`` 1) or raises: training
    over several devices runs one process per rank (``parallel.launch``)."""

    def __init__(self, step_fn: Callable, mesh):
        if mesh.group is None and mesh.n_data > 1:
            raise ValueError("a data-parallel train step runs one process per rank: start "
                             "the ranks with captionax_torch.parallel.launch")
        self.step_fn, self.mesh = step_fn, mesh

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with data_parallel(self.mesh):
            state, metrics = self.step_fn(state, batch)
        return state, reduce_metrics(metrics, self.mesh.group)


def jit_data_parallel(step_fn: Callable, mesh) -> DataParallelStep:
    """``step_fn`` as a data-parallel step over ``mesh`` (params replicated,
    the batch sharded over ``data``).  captionax's ``batch_shardings`` and
    ``example_batch`` have no counterpart: ``shard_batch`` and
    ``BatchLoader(mesh=...)`` place each rank's shard."""
    return DataParallelStep(step_fn, mesh)
