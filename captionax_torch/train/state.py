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

Memory.  The finite check, the moments, the update and its addition to
the parameters run in chunked passes, :data:`CHUNK` elements of a leaf at
a time, each element through the same expressions in the same order as a
whole-tree pass, so the results are bit-equal to it.  The global norm
keeps its per-leaf ``torch.sum(x * x)``: a sum over chunks
would add in another order.  With ``donate=True`` (JAX's buffer donation)
the step writes the moments and the parameters in place and the updates
into the gradients' storage, so the old state and the gradients are
consumed; its temporaries are then one chunk's, and one leaf's square
inside the norm, at most.  Without it the new state is made of new
tensors, and the old state stays as it was.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike
from captionax_torch.interop import to_device
from captionax_torch.parallel.mesh import reduce_gradients

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
MAX_CONSECUTIVE_ERRORS = 100
CHUNK = 1 << 28  # elements of a leaf one optimizer pass takes at a time


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a tree of dicts and lists, dict keys in sorted order (the
    order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unflatten(t, it) -> Any:
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return next(it)


def tree_unflatten(like, leaves) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` (in the order of
    :func:`tree_leaves`).  No closure: a recursive inner function would be
    a reference cycle holding ``leaves`` (a step's gradients) until the
    garbage collector ran."""
    return _unflatten(like, iter(leaves))


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


def _chunked(*tensors):
    """Matching :data:`CHUNK`-element pieces of same-shaped tensors, as
    writable views; tensors that are not all contiguous come whole."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, tensors[0].numel(), CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


class Optimizer:
    """Adam with global-norm clipping, the non-finite skip and an injected
    learning rate; ``init`` and ``update`` as an optax transform has them.
    ``donate``: see the module's docstring."""

    def __init__(self, learning_rate: float, clip_norm: float = 5.0,
                 skip_nonfinite: bool = True, donate: bool = False):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite
        self.donate = donate

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
            finite = torch.stack([torch.isfinite(c).all() for x in g
                                  for (c,) in _chunked(x)]).all()
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    state.notfinite_count + 1)
            ok = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            total = torch.where(finite, state.total_notfinite, state.total_notfinite + 1)
        else:
            ok = torch.ones((), dtype=torch.bool, device=dev)
            notfinite, total = state.notfinite_count, state.total_notfinite
        # clip_by_global_norm: the norm from whole-leaf sums, one leaf at a time
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        below = norm < self.clip_norm
        # scale_by_adam's bias corrections
        adam = state.adam
        count = adam.count + 1
        bc1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=dev), count)
        bc2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=dev), count)
        lr = state.hyperparams["learning_rate"]
        mu, nu = tree_leaves(adam.mu), tree_leaves(adam.nu)
        if self.donate:
            new_mu, new_nu = mu, nu
            upd = [x if x.dtype == torch.promote_types(x.dtype, m.dtype)
                   else torch.empty_like(x, dtype=torch.promote_types(x.dtype, m.dtype))
                   for x, m in zip(g, mu)]
        else:
            new_mu = [torch.empty_like(m) for m in mu]
            new_nu = [torch.empty_like(v) for v in nu]
            upd = [torch.empty_like(x, dtype=torch.promote_types(x.dtype, m.dtype))
                   for x, m in zip(g, mu)]
        for leaf in zip(g, mu, nu, new_mu, new_nu, upd):
            for x, m, v, m_out, v_out, u_out in _chunked(*leaf):
                x = torch.where(below, x, (x / norm.to(x.dtype)) * self.clip_norm)
                m_new = (1 - B1) * x + B1 * m
                v_new = (1 - B2) * (x * x) + B2 * v
                u = (m_new / bc1.to(m_new.dtype)) / (
                    torch.sqrt(v_new / bc2.to(v_new.dtype) + EPS_ROOT) + EPS)
                u = -lr * u
                # apply_if_finite: a dropped step moves nothing and keeps the state
                m_out.copy_(torch.where(ok, m_new, m))
                v_out.copy_(torch.where(ok, v_new, v))
                u_out.copy_(torch.where(ok, u, torch.zeros_like(u)))
        new_adam = AdamState(torch.where(ok, count, adam.count),
                             tree_unflatten(adam.mu, new_mu), tree_unflatten(adam.nu, new_nu))
        return (tree_unflatten(grads, upd),
                OptState(state.hyperparams, notfinite, total, new_adam))


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: torch.Tensor

    def apply_gradients(self, grads, tx: Optimizer) -> "TrainState":
        """The state after one step.  With ``tx.donate`` this state's
        parameters and moments, and ``grads``, are overwritten.  Inside a
        data-parallel step the gradients are first summed over its ranks
        (``parallel.mesh.reduce_gradients``), so the optimizer sees the
        whole batch's."""
        grads = reduce_gradients(grads)
        updates, new_opt = tx.update(grads, self.opt_state, self.params)
        ps, us = tree_leaves(self.params), tree_leaves(updates)
        out = ps if tx.donate else [torch.empty_like(p) for p in ps]
        with torch.no_grad():
            for leaf in zip(ps, us, out):
                for p, u, o in _chunked(*leaf):
                    o.copy_(p + u)
        return TrainState(tree_unflatten(self.params, out), new_opt, self.step + 1)


def make_optimizer(learning_rate: float = 5e-3, clip_norm: float = 5.0,
                   skip_nonfinite: bool = True, donate: bool = False) -> Optimizer:
    """Adam + global-norm clip with an injectable learning rate;
    ``skip_nonfinite`` drops a step with NaN or infinite gradients;
    ``donate`` updates the state in place."""
    return Optimizer(learning_rate, clip_norm, skip_nonfinite, donate)


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
