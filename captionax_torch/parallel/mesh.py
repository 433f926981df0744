"""Device mesh, placement rules and the data-parallel step's reductions.

Port of ``captionax/parallel/mesh.py``.  A :class:`Mesh` holds a 2-D grid
of devices under two axis names: ``("data", "model")`` from
:func:`make_mesh`, ``("data", "pipe")``, ``("data", "seq")`` or
``("data", "expert")`` from ``parallel/pipeline.py`` and
``parallel/sequence.py``.  The ``model`` axis is tensor parallelism:
:func:`vocab_tp_sharding` and :class:`Sharding` split a tensor over it
(:class:`ColumnShards`, :class:`RowShards`), and ``models/layers.py``'s
``linear`` and ``embedding`` and the fused CE compute each part on its own
slot (``scale_check``'s placements).  captionax drives every device of its
mesh from one process; the port runs a mesh in one of two ways:

- **one process over the mesh's devices** (``group`` is None): serving,
  the pipeline and sequence schedules, the expert bank and the tensor
  split.  Each shard of a batch runs on its device and its own stream, and
  a tensor moves between slots with ``.to(device)``, which autograd
  differentiates: a leaf copied to other slots gets their gradients summed
  into it, as captionax's ``psum`` over ``data`` does.  :func:`shard_batch` gives one
  slice per device and :func:`replicate_params` a copy per device (they
  take the place of captionax's ``batch_sharding`` and ``replicated``
  under ``device_put``).
- **one process per rank over** ``torch.distributed`` (``group`` set):
  training.  Rank r holds data shard r.  :func:`shard_batch` gives this
  rank's slice and :func:`replicate_params` broadcasts rank 0's values.
  ``parallel/launch.py`` starts the ranks.

A mesh's devices may repeat: ``[cpu, cpu]`` or ``[cuda:0, cuda:0]`` is how
the CPU tests and a one-card machine hold a mesh of 2, as captionax's tests
hold a virtual 8-device CPU mesh.  Shard r of a batch of B rows is rows
``[r*B/n, (r+1)*B/n)``, captionax's ``P("data")`` order.

Inside :func:`data_parallel` a step's losses divide by the whole batch's
count (:func:`global_sum` all-reduces it) and ``TrainState.apply_gradients``
all-reduces the gradients as sums (:func:`reduce_gradients`), so the
reduced gradient is the gradient of the whole batch's mean.  Outside it
both are the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# the process group of the data-parallel step being run (None: no step)
_ACTIVE = contextvars.ContextVar("captionax_torch_data_parallel", default=None)


class Mesh:
    """A 2-D grid of devices with two axis names (``("data", "model")`` by
    default); ``group`` is the ``torch.distributed`` group when the mesh
    spans processes (then ``rank`` is this process's data index), else
    None."""

    def __init__(self, devices, axis_names: Tuple[str, str] = AXES, group=None,
                 rank: int = 0):
        rows = [[torch.device(d) for d in row] for row in devices]
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def n_data(self) -> int:
        return self.shape.get("data", self.devices.shape[0])

    def axis_slots(self, axis: str, at: int = 0) -> List[torch.device]:
        """The devices along ``axis``, the other axis at index ``at``."""
        if self.axis_names.index(axis) == 0:
            return list(self.devices[:, at])
        return list(self.devices[at, :])

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard, in shard order (each data row's
        first slot)."""
        if "data" in self.axis_names:
            return self.axis_slots("data")
        return list(self.devices[:, 0])

    @property
    def local_device(self) -> torch.device:
        """This process's device: its rank's, or the first shard's."""
        return self.devices[self.rank, 0]

    @property
    def spans_processes(self) -> bool:
        return self.group is not None

    def __repr__(self) -> str:
        where = f", rank {self.rank} of a process group" if self.group is not None else ""
        return f"Mesh({self.shape}, {[str(d) for d in self.data_devices]}{where})"


def default_devices(n: int, device=None) -> List[torch.device]:
    """``n`` mesh slots: on the cards (``device`` None or ``cuda``) slot i is
    card ``i % count``, so a one-card machine repeats its card; ``cpu`` or a
    device with an index fills every slot with it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass device='cpu' for a "
                               "mesh on the CPU")
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the CPU,
    or ranks that share a card: NCCL refuses two ranks on one card)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Inside an initialised process group: the group's mesh, one data shard
    per rank, ``devices`` listing every rank's device (the list the ranks
    were launched on; default: rank r on card ``r % count``, or the CPU
    without a card), this rank's local.  Outside one: a one-process mesh
    over ``devices`` (default: every visible card)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_model != 1 or n_data not in (None, world):
            raise ValueError(f"a process group of {world} ranks holds a mesh "
                             f"[{world}, 1], not [{n_data}, {n_model}]")
        if devices is None:
            devices = default_devices(world, None if torch.cuda.is_available() else "cpu")
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        return Mesh([[d] for d in devices], group=dist.group.WORLD, rank=rank)
    if devices is None:
        devices = default_devices(torch.cuda.device_count() or 1)
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a mesh [{n_data}, {n_model}] needs {n_data * n_model} devices, "
                         f"got {len(devices)}")
    use = devices[: n_data * n_model]
    return Mesh([use[i * n_model:(i + 1) * n_model] for i in range(n_data)])


# ------------------------------------------------------------- placement
def shard_bounds(rows: int, n: int, even: bool = True) -> List[Tuple[int, int]]:
    """The rows ``[start, stop)`` of each of ``n`` shards.  ``even`` requires
    ``rows`` to divide by ``n`` (a training batch); otherwise the first
    ``rows % n`` shards take one row more (an evaluation batch's tail)."""
    if even and rows % n:
        raise ValueError(f"a batch of {rows} rows must divide by the mesh's data axis ({n})")
    base, extra = divmod(rows, n)
    bounds, start = [], 0
    for r in range(n):
        stop = start + base + (r < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def _per_row(key, value, replicated_keys) -> bool:
    return (key not in replicated_keys and isinstance(value, (np.ndarray, torch.Tensor))
            and value.ndim >= 1)


def shard_rows(batch: dict, mesh: Mesh, shard: Optional[int] = None,
               replicated_keys: Sequence[str] = (), even: bool = True) -> dict:
    """Shard ``shard``'s rows (default: this rank's) of every array of
    ``batch`` with a leading axis, but for ``replicated_keys``; the rest
    (scalars such as ``style_id``) as it is."""
    rows = next(len(batch[k]) for k in ("captions", "features", "images", *batch)
                if k in batch and _per_row(k, batch[k], replicated_keys))
    a, b = shard_bounds(rows, mesh.n_data, even)[mesh.rank if shard is None else shard]
    return {k: v[a:b] if _per_row(k, v, replicated_keys) else v for k, v in batch.items()}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def shard_batch(mesh: Mesh, batch: dict):
    """Place a dict of [B, ...] arrays with B split over ``data`` and
    scalars replicated (captionax's ``batch_sharding`` under
    ``device_put``): this rank's slices on its device (a process group), or
    a list of one dict per data shard, each on its shard's device."""
    if mesh.spans_processes:
        return {k: _as_tensor(v).to(mesh.local_device)
                for k, v in shard_rows(batch, mesh).items()}
    return [{k: _as_tensor(v).to(d) for k, v in shard_rows(batch, mesh, r).items()}
            for r, d in enumerate(mesh.data_devices)]


def replicate_params(mesh: Mesh, params):
    """A process group: ``params`` on this rank's device, every leaf
    broadcast from rank 0, so every replica starts bit-equal.  One process:
    a list of one tree per data shard, one copy per distinct device (shards
    on the same device share it)."""
    from captionax_torch.interop import to_device
    from captionax_torch.train.state import tree_leaves, tree_unflatten

    if mesh.spans_processes:
        leaves = [x.detach().to(mesh.local_device).contiguous().clone()
                  for x in tree_leaves(params)]
        for x in leaves:
            dist.broadcast(x, src=0, group=mesh.group)
        return tree_unflatten(params, leaves)
    copies = {}
    for d in mesh.data_devices:
        if d not in copies:
            copies[d] = to_device(params, d)
    return [copies[d] for d in mesh.data_devices]


# --------------------------------------------- the tensor-parallel split
class ColumnShards(list):
    """A tensor split along its last axis over the ``model`` axis (captionax's
    ``P(None, "model")``, or ``P("model")`` for a vector): part k on model
    slot k.  ``linear`` computes each part's columns on its slot and joins
    them on the input's device.  A list, so that the tree functions see
    the parts as leaves."""

    dim = -1

    @property
    def shape(self) -> torch.Size:
        return torch.Size(tuple(self[0].shape[:-1]) + (sum(p.shape[-1] for p in self),))


class RowShards(list):
    """A tensor split along its first axis over the ``model`` axis
    (``P("model", None)``): part k on model slot k.  ``embedding`` looks each
    id up in the part that holds its row and sums the parts' results (the
    others give zeros) on the ids' device."""

    dim = 0

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(p.shape[0] for p in self),) + tuple(self[0].shape[1:]))


SHARDS = (ColumnShards, RowShards)


class Sharding(NamedTuple):
    """Where a tensor lies on a one-process mesh: split along ``dim`` over
    ``mesh``'s ``model`` axis (0: rows, -1: columns), or whole on the first
    slot (``dim`` None).  captionax's ``NamedSharding`` under ``device_put``."""

    mesh: Mesh
    dim: Optional[int] = None

    def place(self, x: torch.Tensor, row: int = 0):
        """``x`` on data row ``row``'s slots: the parts of its split, or the
        whole tensor on the row's first slot."""
        slots = self.mesh.axis_slots("model", row)
        if self.dim is None or len(slots) == 1:
            return x.to(slots[0])
        dim = self.dim % x.ndim
        if x.shape[dim] % len(slots):
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide by the mesh's "
                             f"model axis ({len(slots)})")
        kind = RowShards if dim == 0 and x.ndim > 1 else ColumnShards
        if dim != (0 if kind is RowShards else x.ndim - 1):
            raise ValueError(f"a split along axis {dim} of a {x.ndim}-D tensor is neither "
                             "its rows nor its columns")
        return kind(p.to(d).contiguous() for p, d in zip(x.chunk(len(slots), dim), slots))


def vocab_tp_sharding(mesh: Mesh) -> Sharding:
    """The column split of the fc vocab projection [H, V]: V over ``model``."""
    return Sharding(mesh, -1)


def spec_of(leaf) -> str:
    """captionax's ``PartitionSpec`` of a leaf placed by :class:`Sharding`."""
    if isinstance(leaf, ColumnShards):
        return ("PartitionSpec('model',)" if len(leaf.shape) == 1
                else f"PartitionSpec({', '.join(['None'] * (len(leaf.shape) - 1))}, 'model')")
    if isinstance(leaf, RowShards):
        return f"PartitionSpec('model', {', '.join(['None'] * (len(leaf.shape) - 1))})"
    return "PartitionSpec()"


def column_linear(x: torch.Tensor, w: ColumnShards, b, cast=None) -> torch.Tensor:
    """``x @ w + b`` with ``w``'s (and ``b``'s) parts on their slots: each
    part's columns computed on its slot (``cast`` applied there to the
    operands), joined on ``x``'s device."""
    cast = cast or (lambda t: t)
    outs = [(torch.matmul(cast(x.to(wk.device)), cast(wk)) + cast(bk)).to(x.device)
            for wk, bk in zip(w, b)]
    return torch.cat(outs, dim=-1)


def row_lookup(table: RowShards, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the table's rows split over slots: each part
    gives the rows it holds and zeros elsewhere, and the parts' results are
    summed on ``ids``'s device (each entry is one part's value plus zeros,
    so the sum is exact)."""
    out, start = None, 0
    for part in table:
        n = part.shape[0]
        local = ids.to(part.device) - start
        inside = (local >= 0) & (local < n)
        rows = torch.where(inside[..., None], part[local.clamp(0, n - 1)],
                           torch.zeros((), dtype=part.dtype, device=part.device)).to(ids.device)
        out = rows if out is None else out + rows
        start += n
    return out


def place_on_row(tree, mesh: Mesh, row: int):
    """``tree`` (a tree placed on data row 0) with every tensor on data row
    ``row``'s slots: a split tensor's part k on slot (row, k), a whole one on
    the row's first slot.  Where a slot's device is the leaf's, the leaf
    itself; autograd carries each copy's gradient back to its leaf."""
    if isinstance(tree, SHARDS):
        slots = mesh.axis_slots("model", row)
        return type(tree)(p.to(d) for p, d in zip(tree, slots))
    if isinstance(tree, dict):
        return {k: place_on_row(v, mesh, row) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_on_row(v, mesh, row) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.axis_slots("model", row)[0])
    return tree


# ------------------------------------------- the data-parallel reductions
@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Run a train step's losses and gradient reduction over ``mesh``'s
    process group (a no-op for None or a mesh of one process)."""
    token = _ACTIVE.set(None if mesh is None else mesh.group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def global_sum(x) -> torch.Tensor:
    """``x`` (a count: no gradient flows through it) summed over the ranks of
    the running data-parallel step; ``x`` itself outside one."""
    group = _ACTIVE.get()
    if group is None:
        return x
    x = _as_tensor(x).detach().clone()
    dist.all_reduce(x, group=group)
    return x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the whole batch: this rank's sum over the element
    count of every rank's ``x``, so that the ranks' values sum to the mean."""
    if _ACTIVE.get() is None:
        return torch.mean(x)
    return x.sum() / global_sum(torch.tensor(float(x.numel()), device=x.device))


def _flat_all_reduce(leaves: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each leaf over the group: one all-reduce per dtype, of the
    leaves laid end to end; -> new tensors, views of the reduced buffers."""
    out: List[Any] = [None] * len(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, piece in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return out


def reduce_gradients(grads):
    """The gradients summed over the ranks of the running data-parallel step
    (each rank's loss is its part of the whole batch's, so the sum is the
    whole batch's gradient); ``grads`` itself outside one."""
    group = _ACTIVE.get()
    if group is None:
        return grads
    from captionax_torch.train.state import tree_leaves, tree_unflatten

    return tree_unflatten(grads, _flat_all_reduce(tree_leaves(grads), group))


def reduce_metrics(metrics: dict, group) -> dict:
    """A step's scalar metrics summed over the group: each is the rank's part
    of a whole-batch loss, so the sum is the batch's value."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


def gather_rows(x: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """The whole batch of ``rows`` rows from each rank's shard of it (the
    uneven shards of :func:`shard_bounds`), on every rank."""
    bounds = shard_bounds(rows, mesh.n_data, even=False)
    width = max(b - a for a, b in bounds)
    pad = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    pad[: x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in bounds]
    dist.all_gather(parts, pad, group=mesh.group)
    return torch.cat([p[: b - a] for p, (a, b) in zip(parts, bounds)])

