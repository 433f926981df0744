"""GPipe-style pipeline parallelism over a mesh axis.

Port of ``captionax/parallel/pipeline.py``.  A homogeneous stack of L
layers (LaBERT's 12 BERT layers, either half of CATR's 6 + 6 DETR stacks)
is split into S contiguous stages of L/S layers over the ``pipe`` axis of
a :class:`~captionax_torch.parallel.mesh.Mesh`, and the batch into M
microbatches that flow through the stages: M + S - 1 ticks, stage s runs
microbatch t - s at tick t, the last stage collects.  Output and
gradients equal the sequential stack's (``tests/test_torch_pipeline.py``).

One process drives every slot of the mesh, as captionax's one controller
does.  Stage s's layers are copied to its slot's device once a call (a
copy onto the leaf's own device is the leaf itself), and an activation
moves to the next stage with ``.to(device, non_blocking=True)`` (:func:`move`).  Autograd
differentiates through every move, so the backward needs no schedule of
its own: captionax gets the same from ``jax.grad`` through ``ppermute``.
Work for a device is issued to that device's current stream, so stages
that share a device (a one-card machine repeats its card in every slot)
run in issue order on one stream, and distinct devices overlap.  Only the
(stage, microbatch) pairs that exist are computed: captionax's warm-up
ticks run on garbage and mask it at collection; here there is none to
mask.

On a ``data x pipe`` mesh each data row runs its own ring on its shard of
every microbatch (captionax's ``P(None, "data")``), and the stage weights
are copied onto every row's devices inside the call, so autograd sums the
rows' gradients into one leaf, as captionax's ``psum`` over ``data`` does.
Activations are not routed through ``torch.distributed``: gloo's
point-to-point ops take no CUDA tensors, and a one-card machine cannot run
NCCL across ranks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from captionax_torch.parallel.mesh import Mesh, default_devices


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *z) for z in zip(*trees))
    return fn(*trees)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def stack_layers(layers: Sequence):
    """A list of per-layer parameter trees -> one tree of [L, ...] leaves."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *layers)


def unstack_layers(stacked) -> list:
    """[L, ...] leaves back to a list of per-layer trees (views)."""
    n = _first_leaf(stacked).shape[0]
    return [_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def split_stages(stacked, n_stages: int):
    """Reshape stacked [L, ...] leaves to [S, L // S, ...] (contiguous
    stages).  L must divide by S: the stages are homogeneous."""
    def split(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"layer count {L} not divisible by n_stages={n_stages}")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return _map(split, stacked)


def _stages(layers_params, n_stages: int) -> List[list]:
    """The layer list (or stacked tree) as S lists of L/S layer trees."""
    layers = (list(layers_params) if isinstance(layers_params, (list, tuple))
              else unstack_layers(layers_params))
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"layer count {L} not divisible by n_stages={n_stages}")
    per = L // n_stages
    return [layers[s * per:(s + 1) * per] for s in range(n_stages)]


def _on(tree, device: torch.device):
    return _map(lambda a: a.to(device), tree)


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy onto a card does not block the host (a
    copy to the host does, so that it is whole when it is read)."""
    return t.to(device, non_blocking=device.type == "cuda")


def make_pipeline(layer_fn: Callable, mesh: Mesh, n_micro: int, pipe_axis: str = "pipe",
                  data_axis: Optional[str] = None) -> Callable:
    """``layer_fn(layer_params, x, *extras) -> x`` is one layer.  -> the
    pipelined stack ``f(layers, x, *extras)``: ``layers`` a list of layer
    trees or one tree of stacked [L, ...] leaves, ``x`` [B, ...], each extra
    a per-example [B, ...] tensor handed to the layer with its microbatch
    (attention masks, positions).  The output [B, ...] lies on ``x``'s
    device.  B must divide by ``n_micro``, and a microbatch by the data
    axis."""
    S = mesh.shape[pipe_axis]
    M = n_micro
    n_rows = mesh.shape[data_axis] if data_axis else 1
    rows = [mesh.axis_slots(pipe_axis, r) for r in range(n_rows)]

    def pipelined(layers_params, x: torch.Tensor, *extras) -> torch.Tensor:
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by n_micro={M}")
        mb = B // M
        if mb % n_rows:
            raise ValueError(f"microbatch {mb} not divisible by the data axis ({n_rows})")
        shard = mb // n_rows
        stages = _stages(layers_params, S)
        copies: dict = {}
        outs = []
        for r, devs in enumerate(rows):
            placed = []
            for s, stage in enumerate(stages):
                if (s, devs[s]) not in copies:
                    copies[(s, devs[s])] = [_on(p, devs[s]) for p in stage]
                placed.append(copies[(s, devs[s])])
            state: dict = {}
            for t in range(M + S - 1):
                for s in range(S):
                    m = t - s
                    if not 0 <= m < M:
                        continue
                    lo = m * mb + r * shard
                    h = move(x[lo:lo + shard] if s == 0 else state[m], devs[s])
                    ex = [move(e[lo:lo + shard], devs[s]) for e in extras]
                    for p in placed[s]:
                        h = layer_fn(p, h, *ex)
                    state[m] = h
            outs.append(state)
        return torch.cat([move(outs[r][m], x.device) for m in range(M) for r in range(n_rows)])

    return pipelined


def sequential_apply(layer_fn: Callable, stacked_params, x: torch.Tensor, *extras):
    """The reference semantics of :func:`make_pipeline` on one device: the
    L layers in order."""
    for p in _stages(stacked_params, 1)[0]:
        x = layer_fn(p, x, *extras)
    return x


def _batched(a: torch.Tensor, B: int) -> torch.Tensor:
    """A batch-less [1, ...] tensor broadcast onto the batch axis, so it
    microbatches like everything else."""
    return a.expand((B,) + tuple(a.shape[1:])) if a.shape[0] != B else a


def pipelined_bert_encoder(mesh: Mesh, n_micro: int, num_heads: int, pipe_axis: str = "pipe",
                           data_axis: Optional[str] = None) -> Callable:
    """A drop-in for ``models.transformer.bert_encoder`` running the stack as
    a pipeline over ``mesh``: ``labert_forward(..., encoder_fn=...)``.  The
    additive mask rides the schedule as a per-microbatch extra (a batch-less
    mask is broadcast onto the batch)."""
    from captionax_torch.models.transformer import bert_layer

    pipe = make_pipeline(lambda p, h, m: bert_layer(p, h, num_heads, m), mesh, n_micro,
                         pipe_axis=pipe_axis, data_axis=data_axis)

    def encoder(layers_params, x, heads, mask):
        del heads  # fixed at build time
        return pipe(layers_params, x, _batched(mask, x.shape[0]))

    return encoder


def pipelined_catr_stacks(mesh: Mesh, n_micro: int, num_heads: int, pre_norm: bool = True,
                          pipe_axis: str = "pipe", data_axis: Optional[str] = None):
    """Pipelines for both halves of CATR's DETR transformer, each its own
    stack on the same ``pipe`` ring: -> ``(encoder_fn, decoder_fn)`` for
    ``catr_forward(..., encoder_fn=..., decoder_fn=...)``.  The per-layer
    invariants (sine positions, the decoder's memory, the causal mask) ride
    the schedule as per-microbatch extras."""
    from captionax_torch.models.transformer import detr_decoder_layer, detr_encoder_layer

    enc_pipe = make_pipeline(
        lambda p, h, pos: detr_encoder_layer(p, h, pos, num_heads, pre_norm),
        mesh, n_micro, pipe_axis=pipe_axis, data_axis=data_axis)
    dec_pipe = make_pipeline(
        lambda p, y, mem, tpos, mpos, tmask: detr_decoder_layer(
            p, y, mem, tpos, mpos, num_heads, pre_norm, tgt_mask=tmask),
        mesh, n_micro, pipe_axis=pipe_axis, data_axis=data_axis)

    def encoder_fn(layers_params, x, heads, pos):
        # the model derives heads from hidden // 32 unless told: catch a mismatch
        assert heads == num_heads, (heads, num_heads)
        return enc_pipe(layers_params, x, _batched(pos, x.shape[0]))

    def decoder_fn(layers_params, tgt, memory, tgt_pos, mem_pos, heads, tgt_mask):
        assert heads == num_heads, (heads, num_heads)
        B = tgt.shape[0]
        return dec_pipe(layers_params, tgt, _batched(memory, B), _batched(tgt_pos, B),
                        _batched(mem_pos, B), _batched(tgt_mask, B))

    return encoder_fn, decoder_fn


def pipeline_mesh(n_pipe: int, n_data: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "pipe")`` mesh over the first ``n_data * n_pipe`` of
    ``devices`` (default: slots on the cards, ``default_devices``; a
    one-card machine repeats its card)."""
    devices = list(devices if devices is not None else default_devices(n_data * n_pipe))
    if len(devices) < n_data * n_pipe:
        raise ValueError(f"a mesh [{n_data}, {n_pipe}] needs {n_data * n_pipe} devices, "
                         f"got {len(devices)}")
    return Mesh([devices[r * n_pipe:(r + 1) * n_pipe] for r in range(n_data)], ("data", "pipe"))
