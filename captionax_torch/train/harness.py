"""The training/eval harness: the PyTorch-Lightning-trainer equivalent.

Port of ``captionax/train/harness.py`` for the plain GRU captioner and the
FlickrStyle hypernet: ``fit`` (with the LR sweep, validation, the plateau
LR and the top-1 checkpoint), ``validate``, ``test_beam`` and the frozen
encoder's :class:`FeatureCache`.  Everything runs on ``device`` (the card
unless the caller asks for the CPU).

On the card the train step's teacher-forced recurrence runs on K3 when
``config.fused_scan`` is set (``ops/train_kernel.py``), and the encoder's
stride-1 bottleneck chains run on K4 (``ops/conv_kernel.py``, through
``models.encoder.CNNEncoder``).  ``test_beam`` decodes with the plain
``decode.search.beam_search``, as captionax's decodes with its scan
``beam_search``, so the beam kernels are not on this path.

As in captionax:
- quality metrics (BLEU/METEOR/ROUGE/CIDEr) run on accumulated eval
  decodes, not on every training step;
- the per-step losses stay on the device until the epoch ends (a
  ``float()`` per step would wait for each step to finish); only
  ``log_every`` steps read their scalars;
- ``test_beam`` decodes batch i+1 before it scores batch i on the host.

The hypernet's style-classifier objectives, ``config.mixup`` (the
reference's style mixup) and ``config.style_aux`` (captionax's
style-identification term), score a free-running caption with a frozen
classifier (``style_classifier_params``; ``train/steps.py``'s
``StyleLossStep``).  Their steps run the per-step recurrence, as
captionax's run its scan: ``fused_scan`` and ``bf16_compute`` do not reach
them, so K3 is not on their path; the encoder (K4) is.  Each step draws
from a generator of its own, seeded from ``config.seed`` and the state's
step (:func:`step_generator`), where captionax folds the step into
``PRNGKey(seed)``.  The step is counted on the host
(:class:`DrawingStep`): the card's counter is read only for a state the
step did not make (the first step, a resume, the state ``lr_find``
restores), so the host never waits for a step to finish to draw the next.

``mesh`` (data parallelism, ``parallel/mesh.py``) is a mesh of ranks,
one process each (``parallel.launch``): rank 0's parameters are broadcast
to every rank, each rank's ``BatchLoader`` keeps its shard of every batch
(its ``FeatureCache`` encodes its own shard's images), and the train step
is ``jit_data_parallel``'s (losses over the whole batch, gradients summed
over the ranks before the optimizer: the replicas stay bit-equal).
Validation and ``test_beam`` run over the whole set, each rank on its
shard of every batch (the tail batch split unevenly); the losses are
reduced over the ranks as sums of each shard's loss times its token count
over the batch's count, and the ids the quality metrics read are gathered
in shard order, so every rank computes the same metrics, and the plateau
LR and the checkpoint choice decide alike everywhere.  Only rank 0 logs
and writes checkpoints; the other ranks wait at a barrier until a
checkpoint is written, and :meth:`CaptionTrainer.restore_params` reads one
on rank 0 and broadcasts it.  The split variants of mixup and style-aux raise
with a mesh, as captionax's do.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from captionax_torch.core.config import TrainConfig
from captionax_torch.core.runtime import DeviceLike, host_rss_mb, resolve_device
from captionax_torch.data.loader import REPLICATED_KEYS, BatchLoader
from captionax_torch.data.transforms import preprocess_images
from captionax_torch.decode.search import beam_search
from captionax_torch.eval.metrics import CaptionMetrics, metric_score_test
from captionax_torch.models.encoder import CNNEncoder
from captionax_torch.models.hypernet import hypernet_apply
from captionax_torch.train.checkpoint import BestCheckpointer, latest_step, restore_checkpoint
from captionax_torch.parallel.mesh import gather_rows, replicate_params
from captionax_torch.train.logging import MetricLogger, NullLogger
from captionax_torch.train.state import (
    PlateauScheduler,
    create_train_state,
    get_lr,
    make_optimizer,
    set_lr,
    suggest_lr_from_sweep,
)
from captionax_torch.train.steps import (
    make_gru_steps,
    make_hypernet_mixup_steps,
    make_hypernet_steps,
    make_hypernet_styleaux_steps,
    jit_data_parallel,
    style_token_embed,
)

DEVICE_BATCH_KEYS = ("features", "captions", "style_id", "domain_value",
                     "probe_cls")


class FeatureCache:
    """Cache of frozen-encoder outputs keyed by dataset index.

    The reference re-runs its frozen CNN on every batch of every epoch;
    since the encoder is frozen the features are a pure function of the
    image, so each image is encoded exactly once and served from the cache
    afterwards (float16, ~200 KB/image at 49x2048).  The encoder computes
    in bfloat16, so the f16 round trip is lossless for practical purposes.

    On a miss the WHOLE batch is encoded (captionax's semantics; there the
    reason is one compiled encoder shape).  ``device=False`` keeps the rows
    in host RAM and returns f32 host arrays; ``device=True`` appends them
    to an f16 table on the encoder's device (grown by doubling) and serves
    every batch by one gather and cast to f32 there: no host->card feature
    traffic once an image is cached."""

    def __init__(self, encode_fn, encoder_params, device: bool = False):
        self._encode = encode_fn
        self._params = encoder_params
        self._store: dict = {}
        self._device = device
        self._row: dict = {}      # key -> row index in the device table
        self._table: Optional[torch.Tensor] = None  # [capacity, ...] f16

    def _append_device(self, rows: torch.Tensor) -> None:
        n = len(self._row) - len(rows)  # rows already in the table
        if self._table is None or n + len(rows) > len(self._table):
            cap = max(2 * (0 if self._table is None else len(self._table)), n + len(rows))
            grown = torch.empty((cap,) + tuple(rows.shape[1:]), dtype=torch.float16,
                                device=rows.device)
            if self._table is not None:
                grown[:n] = self._table[:n]
            self._table = grown
        self._table[n:n + len(rows)] = rows

    def __contains__(self, key) -> bool:
        return key in (self._row if self._device else self._store)

    def featurize(self, get_images, indices, namespace: str = ""):
        """``get_images`` is a zero-arg callable so a warm cache never
        materializes the image batch at all.  ``namespace`` separates
        index spaces when one trainer mixes datasets."""
        keys = [(namespace, int(idx)) for idx in indices]
        missing = [i for i, k in enumerate(keys) if k not in self]
        if missing:
            fresh = self._encode(self._params, get_images()).to(torch.float16)
            host = None if self._device else fresh.cpu().numpy()
            new = []
            for i in missing:
                if keys[i] in self:  # duplicate index in batch
                    continue
                if self._device:
                    self._row[keys[i]] = len(self._row)
                    new.append(i)
                else:
                    self._store[keys[i]] = host[i]
            if new:
                idx = torch.tensor(new, device=fresh.device)
                self._append_device(fresh[idx])
        if self._device:
            rows = torch.tensor([self._row[k] for k in keys], device=self._table.device)
            return self._table[rows].float()  # f32 [B, ...] on the device
        return np.stack([self._store[k] for k in keys]).astype(np.float32)


def step_generator(seed: int, step: int) -> torch.Generator:
    """A fresh CPU generator for train step ``step`` of a run with ``seed``:
    the two mixed by numpy's ``SeedSequence``, so that neighbouring seeds
    and steps give unrelated streams."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class DrawingStep:
    """``step(state, batch, generator)`` as ``train_step(state, batch)``,
    each call with ``step_generator(seed, state.step)``.  The step number
    is counted on the host; ``state.step`` is read (a wait for the card)
    only when ``state`` is not the one the previous call returned."""

    def __init__(self, step, seed: int):
        self.step, self.seed = step, int(seed)
        self._made, self._n = None, 0  # the step counter of the last state made, its value

    def __call__(self, state, batch):
        if state.step is not self._made:
            self._n = int(state.step)
        state, metrics = self.step(state, batch, step_generator(self.seed, self._n))
        self._made, self._n = state.step, self._n + 1
        return state, metrics


def _style_loss_step(tx, config: TrainConfig, params, embed_fn, classifier_params):
    """The mixup or style-aux step ``config`` asks for, or None.  The style
    rows are (0, 1, 2) of a dedicated style table, else the vocab rows
    (4, 3, 6); with ``style_aux_from_batch`` the probe's class comes from
    ``batch['probe_cls']``."""
    if config.mixup and config.style_aux:
        raise ValueError("mixup and style_aux are alternative auxiliary "
                         "objectives; enable at most one")
    if not (config.mixup or config.style_aux):
        return None
    name = "mixup" if config.mixup else "style_aux"
    if classifier_params is None:
        raise ValueError(f"config.{name} needs style_classifier_params (train one: "
                         "cli/train_classifier --kind small --save)")
    style_ids = (0, 1, 2) if "style_embed" in params else (4, 3, 6)
    if config.mixup:
        return make_hypernet_mixup_steps(tx, classifier_params, alpha=config.mixup_alpha,
                                         style_ids=style_ids, embed_fn=embed_fn)
    return make_hypernet_styleaux_steps(
        tx, classifier_params, alpha=config.style_aux_alpha,
        style_ids=None if config.style_aux_from_batch else style_ids,
        embed_fn=embed_fn)


class CaptionTrainer:
    def __init__(
        self,
        params,
        kind: str,  # 'gru' | 'hypernet'
        config: TrainConfig,
        vocab,
        encoder_params=None,
        embed_fn: Callable = style_token_embed,
        mesh=None,
        logger: Optional[MetricLogger] = None,
        run_name: str = "run",
        style_classifier_params=None,
        device: DeviceLike = None,
    ):
        if mesh is not None and ((config.mixup and config.mixup_split)
                                 or (config.style_aux and config.style_aux_split)):
            raise ValueError("mixup_split / style_aux_split are single-device; "
                             "drop the split or the mesh")
        self.config = config
        self.vocab = vocab
        self.kind = kind
        self.mesh = mesh
        self.device = mesh.local_device if mesh is not None else resolve_device(device)
        self.rank0 = mesh is None or mesh.rank == 0
        self.encoder_params = encoder_params
        self.logger = logger or (MetricLogger(config.checkpoint_dir, run_name) if self.rank0
                                 else NullLogger())
        self.tx = make_optimizer(config.lr, config.grad_clip)
        if mesh is not None and mesh.spans_processes:
            params = replicate_params(mesh, params)
        self.state = create_train_state(params, self.tx, device=self.device)
        self._embed_fn = embed_fn
        self.style_step = None  # the mixup / style-aux step, when one is set
        if kind == "gru":
            train_step, eval_step = make_gru_steps(
                self.tx, bf16=config.bf16_compute,
                unroll=config.scan_unroll,
                fused_scan=config.fused_scan,
            )
        else:
            train_step, eval_step = make_hypernet_steps(
                self.tx, embed_fn=embed_fn, bf16=config.bf16_compute,
                unroll=config.scan_unroll,
                fused_scan=config.fused_scan,
            )
            self.style_step = style_step = _style_loss_step(
                self.tx, config, params, embed_fn, style_classifier_params)
            if style_step is not None:
                train_step = DrawingStep(style_step, config.seed)
        self._train_step = train_step if mesh is None else jit_data_parallel(train_step, mesh)
        self._eval_step = eval_step
        self._encoder: Optional[CNNEncoder] = None  # made at the first encode
        self.scheduler = PlateauScheduler(
            factor=config.plateau_factor,
            patience=config.plateau_patience,
            cooldown=config.plateau_cooldown,
        )
        self.checkpointer = BestCheckpointer(config.checkpoint_dir, write=self.rank0)
        self.feature_cache = (
            FeatureCache(self._encode, encoder_params,
                         device=config.cache_features_device)
            if (config.cache_features or config.cache_features_device)
            and encoder_params is not None else None
        )
        self.global_step = 0

    def _encode(self, _params, images) -> torch.Tensor:
        """uint8 images [B, H, W, 3] -> region features [B, R, 2048] f32 on
        the device; the encoder's operands are made once, at the first call."""
        if self._encoder is None:
            self._encoder = CNNEncoder(self.encoder_params, device=self.device)
        return self._encoder(preprocess_images(images, self.device))

    def maybe_resume(self, directory: Optional[str] = None) -> bool:
        """Restore params from the latest checkpoint if one exists
        (reference resume = load_from_checkpoint)."""
        directory = directory or self.config.checkpoint_dir
        step = latest_step(directory)
        if step is None:
            return False
        self.restore_params(directory)
        self.global_step = int(step)
        self.logger.log({"resumed_from_step": float(step)})
        return True

    def restore_params(self, directory: Optional[str] = None) -> None:
        """Take the parameters of the latest checkpoint in ``directory``
        (default: the run's).  With a mesh of ranks rank 0 reads them and
        broadcasts them, so every replica holds rank 0's."""
        directory = directory or self.config.checkpoint_dir
        params = (restore_checkpoint(directory, like=self.state.params) if self.rank0
                  else self.state.params)
        if self.mesh is not None and self.mesh.spans_processes:
            params = replicate_params(self.mesh, params)
        self.state = self.state._replace(params=params)

    # -- plumbing -------------------------------------------------------
    def _loader(self, batches, even: bool = True,
                replicated_keys: tuple = REPLICATED_KEYS) -> BatchLoader:
        # with an active feature cache, images stay on the host (a warm
        # cache never reads them)
        keys = (DEVICE_BATCH_KEYS if self.feature_cache is not None
                else ("images", "captions", "features"))
        return BatchLoader(batches, device=self.device, device_keys=keys, mesh=self.mesh,
                           even=even, replicated_keys=replicated_keys)

    def _featurize(self, batch: Dict) -> Dict:
        if "features" not in batch and "images" in batch:
            if self.encoder_params is None:
                raise ValueError("a batch of images needs encoder_params")
            batch = dict(batch)
            if self.feature_cache is not None and "indices" in batch:
                batch["features"] = self.feature_cache.featurize(
                    lambda: batch["images"], batch["indices"],
                    namespace=str(batch.get("index_ns", "")),
                )
            else:
                batch["features"] = self._encode(self.encoder_params, batch["images"])
        return {k: v for k, v in batch.items() if k in DEVICE_BATCH_KEYS}

    @property
    def params(self):
        return self.state.params

    def decoder_params(self):
        return self.params["decoder"] if self.kind != "gru" else self.params

    # -- LR finder ------------------------------------------------------
    def lr_find(
        self,
        train_batches: Callable[[int], Iterable[Dict]],
        num_training: int = 100,
        min_lr: float = 1e-6,
        max_lr: float = 1.0,
        beta: float = 0.98,
    ) -> Optional[float]:
        """Exponential LR sweep + steepest-descent suggestion — the
        pl.Trainer ``tune()``/``auto_lr_find`` step every reference
        trainer runs before fit.

        Runs up to ``num_training`` optimizer steps with the LR swept
        geometrically from ``min_lr`` to ``max_lr``, tracking the
        bias-corrected EWMA of the loss (Lightning's smoothing), stops
        early on divergence (smoothed loss > 4x best), then restores the
        pre-sweep state and installs the suggested LR."""
        # the train step never writes into the state it is given (each
        # step returns new tensors), so a reference is a valid snapshot
        saved_state = self.state
        saved_step = self.global_step
        ratio = (max_lr / min_lr) ** (1.0 / max(num_training - 1, 1))
        lrs, losses = [], []
        avg, best = 0.0, float("inf")
        i = 0
        done = False
        epoch = 0
        while not done and i < num_training:
            got_batch = False
            for batch in self._loader(train_batches(epoch)):
                got_batch = True
                lr = min_lr * (ratio ** i)
                self.state = set_lr(self.state, lr)
                db = self._featurize(batch)
                self.state, metrics = self._train_step(self.state, db)
                loss = float(metrics["train_loss"])
                avg = beta * avg + (1 - beta) * loss
                smoothed = avg / (1 - beta ** (len(losses) + 1))
                lrs.append(lr)
                losses.append(smoothed)
                if math.isfinite(smoothed):
                    best = min(best, smoothed)
                i += 1
                if i >= num_training or (
                    len(losses) > 10
                    and (not math.isfinite(smoothed) or smoothed > 4 * best)
                ):
                    done = True
                    break
            if not got_batch:
                break
            epoch += 1
        self.state = saved_state
        self.global_step = saved_step
        suggestion = suggest_lr_from_sweep(lrs, losses)
        if suggestion is not None:
            self.state = set_lr(self.state, suggestion)
            self.logger.log({"lr_find_suggestion": suggestion})
        return suggestion

    # -- loops ----------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[[int], Iterable[Dict]],
        val_batches: Optional[Callable[[], Iterable[Dict]]] = None,
        epoch_end_metrics: Optional[Callable[[Any], Dict]] = None,
    ) -> Dict:
        """train_batches(epoch) / val_batches() yield host batch dicts.

        ``epoch_end_metrics(params) -> dict`` is an optional per-epoch
        hook; its scalars are logged with the epoch metrics and are
        eligible as the checkpoint-selection monitor
        (``config.select_metric`` / ``select_mode``)."""
        cfg = self.config
        history = {}
        if cfg.auto_lr_find:
            found = self.lr_find(train_batches,
                                 num_training=cfg.lr_find_steps)
            print(f"lr_find: suggested lr={found}")
        if cfg.trace_dir:
            from captionax_torch.core.runtime import trace

            with trace(cfg.trace_dir):
                return self._fit_epochs(train_batches, val_batches, history,
                                        epoch_end_metrics)
        return self._fit_epochs(train_batches, val_batches, history,
                                epoch_end_metrics)

    def _fit_epochs(self, train_batches, val_batches, history,
                    epoch_end_metrics=None) -> Dict:
        cfg = self.config
        for epoch in range(cfg.max_epochs):
            t0 = time.time()
            n = 0
            # per-step losses stay ON DEVICE until the epoch ends: a
            # float() per step waits for the step to finish, and the host
            # could not queue the next one meanwhile.  log_every steps
            # still sync — the intended bounded checkpoint of progress
            step_losses = []
            for batch in self._loader(train_batches(epoch)):
                db = self._featurize(batch)
                self.state, metrics = self._train_step(self.state, db)
                self.global_step += 1
                n += 1
                step_losses.append(metrics["train_loss"])
                if self.global_step % cfg.log_every == 0:
                    self.logger.log(
                        {**{k: float(v) for k, v in metrics.items()},
                         "lr": get_lr(self.state), "epoch": epoch},
                        step=self.global_step,
                    )
            if n == 0:
                raise RuntimeError(
                    f"epoch {epoch} produced ZERO training batches — "
                    "misconfigured data (e.g. batch_size larger than every "
                    "domain/style group, empty caption file, or an "
                    "over-restrictive index split)"
                )
            # one read of all the epoch's losses, summed on the host in
            # step order as captionax sums them
            loss_sum = float(sum(float(x) for x in torch.stack(step_losses).cpu()))
            epoch_metrics = {
                "epoch": epoch,
                "train_loss_epoch": loss_sum / max(n, 1),
                "epoch_seconds": time.time() - t0,
                "rss_mb": host_rss_mb(),
            }
            if val_batches is not None:
                val = self.validate(
                    val_batches(),
                    with_quality_metrics=not cfg.skip_val_quality)
                epoch_metrics.update(val)
                lr = self.scheduler.step(val["val_loss_tf"], get_lr(self.state))
                if lr != get_lr(self.state):
                    self.state = set_lr(self.state, lr)
            if epoch_end_metrics is not None:
                epoch_metrics.update(epoch_end_metrics(self.params))
            monitored = epoch_metrics.get(cfg.select_metric)
            if monitored is not None:
                # BestCheckpointer is min-based; negate for mode="max".  Every
                # rank takes the same decision on the same metrics; rank 0
                # writes, and the others wait until the checkpoint is whole
                self.checkpointer.maybe_save(
                    float(monitored) if cfg.select_mode == "min"
                    else -float(monitored),
                    self.global_step, self.state.params,
                )
                if self.mesh is not None and self.mesh.spans_processes:
                    dist.barrier(group=self.mesh.group)
            self.logger.log(epoch_metrics, step=self.global_step)
            history[epoch] = epoch_metrics
        return history

    def _eval_shard(self, batch: Dict):
        """(features and captions of this rank's shard, the eval step's
        output or None for an empty shard)."""
        if len(batch["captions"]) == 0:
            return {k: v for k, v in batch.items() if k in DEVICE_BATCH_KEYS}, None
        db = self._featurize(batch)
        return db, self._eval_step(self.params, db)

    def _gathered(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """The whole batch of a per-row result (this rank's shard alone
        without a mesh of ranks)."""
        if self.mesh is None or not self.mesh.spans_processes:
            return x
        return gather_rows(x, rows, self.mesh)

    def _batch_losses(self, losses) -> list:
        """[(val_loss_tf, val_loss)] per batch: without a mesh the eval
        step's own; with one, each rank's (loss x tokens) summed over the
        ranks and divided by the batch's tokens."""
        if self.mesh is None or not self.mesh.spans_processes:
            return [(a, b) for a, b, _ in losses]
        if not losses:
            return []
        sums = torch.stack([torch.stack([a * c, b * c, c]) for a, b, c in losses])
        dist.all_reduce(sums, group=self.mesh.group)
        return [(a / torch.clamp(c, min=1.0), b / torch.clamp(c, min=1.0))
                for a, b, c in sums.unbind()]

    def validate(self, batches: Iterable[Dict],
                 with_quality_metrics: bool = True) -> Dict:
        n = 0
        quality = CaptionMetrics(self.vocab) if with_quality_metrics else None
        # loss scalars stay on the device until the loop ends (the
        # training loop's deferred fetch)
        losses = []
        zero = torch.zeros((), device=self.device)
        for batch in self._loader(_with_rows(batches), even=False):
            db, out = self._eval_shard(batch)
            if out is None:
                losses.append((zero, zero, zero))
            else:
                count = (db["captions"] != 0).sum().float()
                losses.append((out["val_loss_tf"], out["val_loss"], count))
            if quality is not None:
                ids = (torch.zeros(db["captions"].shape, dtype=torch.int64, device=self.device)
                       if out is None else out["logits_tf"].argmax(dim=-1))
                rows = batch["batch_rows"]
                quality.add_batch_ids(self._gathered(db["captions"], rows),
                                      self._gathered(ids, rows))
            n += 1
        losses = self._batch_losses(losses)
        sums: Dict[str, float] = {
            "val_loss_tf": sum(float(a) for a, _ in losses),
            "val_loss": sum(float(b) for _, b in losses),
        }
        out = {k: v / max(n, 1) for k, v in sums.items()}
        if quality is not None and n:
            out.update({f"val_{k}": v for k, v in quality.compute().items()})
        return out

    def test_beam(self, batches: Iterable[Dict]) -> Dict:
        """Reference test_step: k-beam decode + metrics of the best
        hypothesis against the batch refs, plus TF metrics.

        Additionally reports corpus-level beam metrics (``beam_corpus_*``)
        over all decoded hypotheses — the reference's per-image
        metric_score_test cannot produce a meaningful CIDEr (corpus df
        over a single image is identically zero)."""
        cfg = self.config
        agg: Dict[str, float] = {}
        n_scored = 0
        tf_quality = CaptionMetrics(self.vocab)
        beam_quality = CaptionMetrics(self.vocab)

        def process(fetched, caps):
            nonlocal n_scored
            found, toks, tf_ids = _wait_host(fetched)
            found = found.astype(bool)
            for i in range(len(found)):
                if not found[i]:
                    continue
                scores = metric_score_test(caps[i : i + 1], toks[i], self.vocab)
                for k, v in scores.items():
                    agg[f"beam_{k}"] = agg.get(f"beam_{k}", 0.0) + v
                n_scored += 1
            beam_quality.add_batch_ids(caps, toks)
            tf_quality.add_batch_ids(caps, tf_ids)

        def with_host_captions(bs):
            for b in _with_rows(bs):
                yield {**b, "host_captions": np.asarray(b["captions"])}

        # one-deep pipelining: queue batch i+1's decode on the card before
        # batch i's results are scored on the host.  Batch i's results are
        # copied to pinned host memory behind its own work and waited for
        # by their event alone, so the card decodes batch i+1 meanwhile
        pending = None
        with torch.no_grad():
            for batch in self._loader(with_host_captions(batches), even=False,
                                      replicated_keys=REPLICATED_KEYS + ("host_captions",)):
                caps = batch["host_captions"]
                db, out = self._eval_shard(batch)
                if out is None:  # an empty shard of a tail batch
                    found = torch.zeros((0,), dtype=torch.int32, device=self.device)
                    toks = torch.zeros((0, cfg.beam_max_steps + 1), dtype=torch.int32,
                                       device=self.device)
                    tf_ids = torch.zeros((0,) + tuple(db["captions"].shape[1:]),
                                         dtype=torch.int64, device=self.device)
                else:
                    if self.kind == "gru":
                        decoder, theta = self.params, None
                    else:
                        decoder = self.params["decoder"]
                        theta = hypernet_apply(
                            self.params["hn"], self._embed_fn(self.params, db)
                        )
                    res = beam_search(decoder, db["features"], k=cfg.beam_size,
                                      max_steps=cfg.beam_max_steps, gru_params=theta,
                                      device=self.device)
                    found, toks = res.found.to(torch.int32), res.tokens
                    tf_ids = out["logits_tf"].argmax(dim=-1)
                rows = batch["batch_rows"]
                fetched = _to_host_async(tuple(
                    self._gathered(x, rows) for x in (found, toks, tf_ids)))
                if pending is not None:
                    process(*pending)
                pending = (fetched, caps)
            if pending is not None:
                process(*pending)
        result = {k: v / max(n_scored, 1) for k, v in agg.items()}
        result.update({f"tf_{k}": v for k, v in tf_quality.compute().items()})
        result.update(
            {f"beam_corpus_{k}": v for k, v in beam_quality.compute().items()}
        )
        result["beam_completed"] = n_scored
        return result


def _with_rows(batches):
    """Each batch with its row count, ``batch_rows``: a rank's shard of it
    needs the whole batch's to gather its rows."""
    for b in batches:
        yield {**b, "batch_rows": len(b["captions"])}


def _to_host_async(tensors):
    """Start copying ``tensors`` to the host: -> (host tensors, event).  On
    the card each copy lands in fresh pinned memory behind the work queued
    so far, and the event marks the copies' end; on the CPU there is
    nothing to wait for."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _wait_host(fetched):
    """Wait for :func:`_to_host_async`'s copies -> numpy arrays."""
    host, event = fetched
    if event is not None:
        event.synchronize()
    return [t.numpy() for t in host]
