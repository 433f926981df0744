"""Checkpoints, and the reference's "module surgery" pattern.

Port of ``captionax/train/checkpoint.py`` with the port's own format: one
directory per step, ``<directory>/<step>/``, holding ``tree.pt``, a
``torch.save`` of plain dicts and lists of CPU tensors (NamedTuples are
saved as dicts), loadable with ``torch.load(..., weights_only=True)``.  A
step is written to a temporary directory and renamed into place, so a
step directory is always whole.  ``max_to_keep`` prunes the oldest step
directories.  Other files in the directory (the metric logger's
``<run_name>.jsonl``) are left alone: only directories whose names are
integers are steps.

Reference behavior: Lightning ModelCheckpoint keeps the top-1 on
'val_loss with TF'; resume loads full checkpoints; and hypernet training
warm-starts by copying the shared submodules
(image_encoder/feature_fc/embed/fc/attention/init_h) from a pretrained
plain captioner — here :func:`graft_pretrained_captioner`.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

TREE_FILE = "tree.pt"


def _plain(tree: Any) -> Any:
    """NamedTuples -> dicts, tuples -> lists, tensors -> detached CPU
    tensors; the tree ``torch.load(weights_only=True)`` reads back."""
    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, TREE_FILE))
    )


def save_checkpoint(directory: str, step: int, tree: Any,
                    max_to_keep: int = 1) -> None:
    """Write ``tree`` as step ``step``; then keep the newest
    ``max_to_keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_plain(tree), os.path.join(tmp, TREE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in _steps(directory)[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(old)))


def _match(tree: Any, like: Any, path: str) -> Any:
    """``tree`` checked against ``like`` (keys, lengths, shapes, dtypes),
    each tensor placed on the device of ``like``'s."""
    like = _plain_structure(like)
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint tree at {path or '/'}: keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)} "
                             f"!= {sorted(like)}")
        return {k: _match(tree[k], like[k], f"{path}/{k}") for k in like}
    if isinstance(like, list):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"checkpoint tree at {path}: not a list of {len(like)}")
        return [_match(a, b, f"{path}/{i}") for i, (a, b) in enumerate(zip(tree, like))]
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor):
            raise ValueError(f"checkpoint tree at {path}: not a tensor")
        if tree.shape != like.shape or tree.dtype != like.dtype:
            raise ValueError(f"checkpoint tree at {path}: {tuple(tree.shape)} {tree.dtype} "
                             f"!= {tuple(like.shape)} {like.dtype}")
        return tree.to(like.device)
    return tree


def _plain_structure(tree: Any) -> Any:
    """One level of :func:`_plain` without copying tensors."""
    if hasattr(tree, "_asdict"):
        return tree._asdict()
    if isinstance(tree, tuple):
        return list(tree)
    return tree


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       like: Any = None) -> Any:
    """The tree saved as ``step`` (the latest when None).  With ``like``,
    the tree must have its structure, shapes and dtypes, and every tensor
    comes back on the device of ``like``'s; without it, on the CPU."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(int(step)), TREE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint step {step} under {directory}")
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree if like is None else _match(tree, like, "")


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_train_state(directory: str, step: int, state,
                     max_to_keep: int = 1) -> None:
    """Checkpoint the FULL TrainState (params + optimizer moments + step)
    so resume continues Adam exactly where it left off — the reference's
    Lightning checkpoints carry optimizer state too."""
    save_checkpoint(
        directory, step,
        {"params": state.params, "opt_state": state.opt_state,
         "step": state.step},
        max_to_keep,
    )


def restore_train_state(directory: str, like_state,
                        step: Optional[int] = None):
    """Restore a full TrainState saved by save_train_state, on the devices
    of ``like_state``'s tensors."""
    from captionax_torch.train.state import AdamState, OptState

    tree = restore_checkpoint(
        directory, step,
        like={"params": like_state.params, "opt_state": like_state.opt_state,
              "step": like_state.step},
    )
    o = tree["opt_state"]
    adam = o["adam"]
    opt_state = OptState(o["hyperparams"], o["notfinite_count"], o["total_notfinite"],
                         AdamState(adam["count"], adam["mu"], adam["nu"]))
    return like_state._replace(
        params=tree["params"], opt_state=opt_state, step=tree["step"]
    )


SHARED_SUBMODULES = ("feature_fc", "embed", "fc", "attention", "init_h")


def graft_pretrained_captioner(model_params, captioner_params):
    """Copy the shared decoder submodules from a pretrained plain
    captioner into a hypernet model's decoder (reference ckpt surgery)."""
    decoder = dict(model_params["decoder"])
    for name in SHARED_SUBMODULES:
        decoder[name] = captioner_params[name]
    out = dict(model_params)
    out["decoder"] = decoder
    return out


class BestCheckpointer:
    """ModelCheckpoint(save_top_k=1, monitor=min) equivalent.  With
    ``write=False`` it keeps the best metric and takes the same decisions
    but writes nothing (a data-parallel rank other than 0)."""

    def __init__(self, directory: str, max_to_keep: int = 1, write: bool = True):
        self.directory = directory
        self.best: Optional[float] = None
        self.max_to_keep = max_to_keep
        self.write = write

    def maybe_save(self, metric: float, step: int, tree: Any) -> bool:
        if self.best is None or metric < self.best:
            self.best = metric
            if self.write:
                save_checkpoint(self.directory, step, tree, self.max_to_keep)
            return True
        return False
