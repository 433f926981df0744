"""Weight carry between the JAX package's parameter trees and the port.

A captionax parameter tree is nested dicts (and lists, for extra GRU
layers) of arrays.  :func:`from_jax_params` copies every leaf into a tensor
with the same shape and layout — ``linear`` weights stay ``[in, out]``, GRU
tensors stay in torch gate order — so the port's functions consume the
same tree the JAX functions do.  :func:`to_numpy_tree` is the inverse; the
round trip is bit-exact for float32 leaves.  :func:`from_optax_state`
carries the JAX package's optimizer state (``make_optimizer``'s optax
chain) into the port's ``OptState``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def from_jax_params(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Tree of arrays (numpy, or anything ``np.asarray`` reads) -> the same
    tree of tensors on ``device``, cast to ``dtype`` when given."""
    dev = resolve_device(device)

    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return _map_tree(leaf, tree)


def to_device(tree: Any, device: DeviceLike = None) -> Any:
    """Tree of tensors (or arrays) -> the same tree on ``device``; leaves
    already there are not copied."""
    dev = resolve_device(device)
    return _map_tree(lambda x: torch.as_tensor(x).to(dev), tree)


def to_numpy_tree(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (host copies)."""
    return _map_tree(lambda t: t.detach().cpu().numpy(), tree)


def from_optax_state(opt_state: Any, device: DeviceLike = None):
    """The state of captionax's ``make_optimizer`` (inject_hyperparams over
    apply_if_finite over clip_by_global_norm + adam), leaves as numpy
    arrays or anything ``np.asarray`` reads -> the port's ``OptState`` on
    ``device``.  Reads the states' fields by name; optax is not imported."""
    from captionax_torch.train.state import AdamState, OptState

    finite = opt_state.inner_state
    adam = finite.inner_state[1][0]
    scalar = lambda x, dt: torch.tensor(np.array(x), dtype=dt, device=resolve_device(device))
    return OptState(
        {"learning_rate": scalar(opt_state.hyperparams["learning_rate"], torch.float32)},
        scalar(finite.notfinite_count, torch.int32),
        scalar(finite.total_notfinite, torch.int32),
        AdamState(scalar(adam.count, torch.int32), from_jax_params(adam.mu, device),
                  from_jax_params(adam.nu, device)))
