"""Train state, optimizer and plateau LR scheduling.

Port of ``captionax/train/state.py``.  The optimizer is the JAX package's
optax chain written out as plain tensor functions, in optax's order of
operations:

1. ``apply_if_finite(max_consecutive_errors=100)``: a step whose gradients
   hold a NaN or an infinity is dropped — parameters, moments and Adam's
   count stay as they were — until more than 100 such steps come in a row;
2. ``clip_by_global_norm(clip_norm)``: ``g`` when the global norm is below
   ``clip_norm``, else ``(g / norm) * clip_norm``;
3. ``adam``: b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, with bias
   correction, ``mu_hat / (sqrt(nu_hat) + eps)``, scaled by ``-lr``;
4. ``inject_hyperparams``: the learning rate is a tensor of the optimizer
   state, so :func:`set_lr` changes it without rebuilding anything.

The update is branch-free (``torch.where`` on a device flag), so a step
never waits on the host to learn whether its gradients were finite.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.interop import to_device

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
MAX_CONSECUTIVE_ERRORS = 100


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a tree of dicts and lists, dict keys in sorted order (the
    order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn, *trees) -> Any:
    cols = [tree_leaves(t) for t in trees]
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*cols)])


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 [], steps applied
    mu: Any               # first moments, the tree of the parameters
    nu: Any               # second moments


class OptState(NamedTuple):
    hyperparams: Dict[str, torch.Tensor]  # {"learning_rate": f32 []}
    notfinite_count: torch.Tensor         # int32 [], non-finite steps in a row
    total_notfinite: torch.Tensor         # int32 [], non-finite steps in all
    adam: AdamState


class Optimizer:
    """Adam with global-norm clipping, the non-finite skip and an injected
    learning rate; ``init`` and ``update`` as an optax transform has them."""

    def __init__(self, learning_rate: float, clip_norm: float = 5.0,
                 skip_nonfinite: bool = True):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite

    def init(self, params) -> OptState:
        dev = tree_leaves(params)[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        moments = lambda: tree_map(torch.zeros_like, params)
        return OptState(
            {"learning_rate": torch.tensor(self.learning_rate, dtype=torch.float32,
                                           device=dev)},
            zero.clone(), zero.clone(), AdamState(zero.clone(), moments(), moments()))

    @torch.no_grad()
    def update(self, grads, state: OptState, params=None):
        """-> (updates, new state); ``params + updates`` is the new point."""
        del params
        g = tree_leaves(grads)
        dev = g[0].device
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    state.notfinite_count + 1)
            ok = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            total = torch.where(finite, state.total_notfinite, state.total_notfinite + 1)
        else:
            ok = torch.ones((), dtype=torch.bool, device=dev)
            notfinite, total = state.notfinite_count, state.total_notfinite
        # clip_by_global_norm
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        below = norm < self.clip_norm
        g = [torch.where(below, x, (x / norm.to(x.dtype)) * self.clip_norm) for x in g]
        # scale_by_adam
        adam = state.adam
        mu = [(1 - B1) * x + B1 * m for x, m in zip(g, tree_leaves(adam.mu))]
        nu = [(1 - B2) * (x * x) + B2 * v for x, v in zip(g, tree_leaves(adam.nu))]
        count = adam.count + 1
        bc1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=dev), count)
        bc2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=dev), count)
        lr = state.hyperparams["learning_rate"]
        upd = [(m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype) + EPS_ROOT) + EPS)
               for m, v in zip(mu, nu)]
        upd = [-lr * u for u in upd]
        # apply_if_finite: a dropped step moves nothing and keeps the state
        keep = lambda new, old: [torch.where(ok, a, b) for a, b in zip(new, old)]
        new_adam = AdamState(
            torch.where(ok, count, adam.count),
            tree_unflatten(adam.mu, keep(mu, tree_leaves(adam.mu))),
            tree_unflatten(adam.nu, keep(nu, tree_leaves(adam.nu))))
        upd = [torch.where(ok, u, torch.zeros_like(u)) for u in upd]
        return (tree_unflatten(grads, upd),
                OptState(state.hyperparams, notfinite, total, new_adam))


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: torch.Tensor

    def apply_gradients(self, grads, tx: Optimizer) -> "TrainState":
        updates, new_opt = tx.update(grads, self.opt_state, self.params)
        with torch.no_grad():
            params = tree_map(lambda p, u: (p + u).to(p.dtype), self.params, updates)
        return TrainState(params, new_opt, self.step + 1)


def make_optimizer(learning_rate: float = 5e-3, clip_norm: float = 5.0,
                   skip_nonfinite: bool = True) -> Optimizer:
    """Adam + global-norm clip with an injectable learning rate;
    ``skip_nonfinite`` drops a step with NaN or infinite gradients."""
    return Optimizer(learning_rate, clip_norm, skip_nonfinite)


def create_train_state(params, tx: Optimizer, step: int = 0,
                       device: DeviceLike = None) -> TrainState:
    """The state on ``device`` (the card unless the caller asks for the
    CPU): the parameters are moved there, moments start at zero."""
    params = to_device(params, device)
    dev = tree_leaves(params)[0].device
    return TrainState(params, tx.init(params),
                      torch.tensor(step, dtype=torch.int32, device=dev))


def get_lr(state: TrainState) -> float:
    return float(state.opt_state.hyperparams["learning_rate"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    hp = dict(state.opt_state.hyperparams)
    hp["learning_rate"] = torch.tensor(lr, dtype=torch.float32,
                                       device=hp["learning_rate"].device)
    return state._replace(opt_state=state.opt_state._replace(hyperparams=hp))


def suggest_lr_from_sweep(lrs, losses, skip_begin: int = 10,
                          skip_end: int = 1) -> Optional[float]:
    """The LR at the steepest descent of the loss curve (Lightning's
    LRFinder suggestion: argmin of the loss gradient over the swept
    window, edges skipped); host-side numpy."""
    lrs = np.asarray(lrs, np.float64)
    losses = np.asarray(losses, np.float64)
    finite = np.isfinite(losses)
    if finite.sum() < max(skip_begin + skip_end + 2, 4):
        # the sweep diverged almost at once: the last finite-loss lr / 10
        return float(lrs[finite][-1] / 10.0) if finite.any() else None
    lo = min(skip_begin, max(0, finite.sum() - 3))
    hi = len(losses) - skip_end
    seg = losses[lo:hi]
    seg_lrs = lrs[lo:hi]
    good = np.isfinite(seg)
    grad = np.gradient(np.where(good, seg, np.nanmax(seg[good])))
    grad[~good] = np.inf
    return float(seg_lrs[int(np.argmin(grad))])


class PlateauScheduler:
    """torch ReduceLROnPlateau semantics (mode=min): ``patience`` epochs
    without improvement scale the LR by ``factor``, then ``cooldown``
    epochs suppress further reductions."""

    def __init__(self, factor: float = 0.5, patience: int = 10, cooldown: int = 2,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.cooldown_left = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed the epoch's monitored metric; returns the (maybe reduced) lr."""
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                lr = max(lr * self.factor, self.min_lr)
                self.cooldown_left = self.cooldown
                self.bad_epochs = 0
        return lr
