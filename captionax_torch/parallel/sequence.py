"""Sequence and expert parallelism over named mesh axes.

Port of ``captionax/parallel/sequence.py``, in the process model of
``parallel/pipeline.py``: one process drives every slot, tensors move
between slots with ``.to(device)`` (:func:`~captionax_torch.parallel.pipeline.move`),
and autograd differentiates through the moves.

**Sequence parallelism** (``seq`` axis): the activations [B, T, D] are
split over T, slot i holding tokens ``[i*T/S, (i+1)*T/S)``.  Layer norm,
the FFN and the residuals act on each token alone, so they run on the
slot's shard; attention needs every key, and has two schedules:

- ``ring=False``: each slot projects K and V of its own tokens, and the
  shards are joined on every slot (captionax's ``all_gather``); the
  slot's queries attend to all of them, with complete softmax rows, so
  the result is the dense attention's up to the order of sums;
- ``ring=True``: S steps of an online softmax (running max, denominator
  and numerator in f32, the max started at -1e30 rather than -inf so that
  ``exp`` and its gradient stay clean), each K/V block passed on to the
  next slot after every step but the last (captionax's ``ppermute``).

A padding mask ([B, 1, 1, T]) serves every query; a mask with a query
axis (causal, [1, 1, T, T]) follows the query shard (:func:`_mask_rows`).
On a ``data x seq`` mesh each data row holds its shard of the batch.  The
attention products are dense ``torch.einsum`` / ``torch.softmax``, as the
rest of the port's transformers (captionax leaves them to XLA, outside any
Pallas kernel).

**Expert parallelism** (``expert`` axis): :func:`expert_theta_bank`
splits the S conditioning rows of a theta bank over the slots, each slot
runs the hypernet over its rows, and the bank is joined: equal to
``train.steps.synthesize_theta_batched``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from captionax_torch.models.layers import linear
from captionax_torch.models.transformer import ffn, layer_norm
from captionax_torch.parallel.mesh import Mesh, default_devices
from captionax_torch.parallel.pipeline import _map, move, unstack_layers


def sequence_mesh(n_seq: int, n_data: int = 1, seq_axis: str = "seq", data_axis: str = "data",
                  devices: Optional[Sequence] = None) -> Mesh:
    """A ``data x seq`` mesh over the first ``n_data * n_seq`` of ``devices``
    (default: slots on the cards, ``default_devices``)."""
    devices = list(devices if devices is not None else default_devices(n_data * n_seq))
    if len(devices) < n_data * n_seq:
        raise ValueError(f"a mesh [{n_data}, {n_seq}] needs {n_data * n_seq} devices, "
                         f"got {len(devices)}")
    return Mesh([devices[r * n_seq:(r + 1) * n_seq] for r in range(n_data)],
                (data_axis, seq_axis))


def _mask_rows(mask: Optional[torch.Tensor], q_start: int, tq: int):
    """The additive mask's query axis (-2) cut to a shard's rows: a padding
    mask ([B, 1, 1, Tk]) serves every query and passes through; a mask with
    a full query axis (causal) follows the query shard."""
    if mask is None or mask.shape[-2] == 1:
        return mask
    return mask[..., q_start:q_start + tq, :]


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, t, D = x.shape
    return x.reshape(B, t, num_heads, D // num_heads)


def _mha_allgather(ps, xs, masks, num_heads: int) -> List[torch.Tensor]:
    """Attention of each query shard to every shard's K and V, joined on the
    query's slot; complete softmax rows."""
    S = len(xs)
    ks = [linear(p["k"], x) for p, x in zip(ps, xs)]
    vs = [linear(p["v"], x) for p, x in zip(ps, xs)]
    out = []
    for i, (p, x) in enumerate(zip(ps, xs)):
        B, tq, D = x.shape
        hd = D // num_heads
        q = _heads(linear(p["q"], x), num_heads)
        k = _heads(torch.cat([move(ks[j], x.device) for j in range(S)], dim=1), num_heads)
        v = _heads(torch.cat([move(vs[j], x.device) for j in range(S)], dim=1), num_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if masks[i] is not None:
            scores = scores + _mask_rows(masks[i], i * tq, tq)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, tq, D)
        out.append(linear(p["o"], ctx))
    return out


def _mha_ring(ps, xs, masks, num_heads: int) -> List[torch.Tensor]:
    """Ring attention: after ``step`` hops slot i holds the K/V block of
    slot i - step and folds it into its running (max, denominator,
    numerator)."""
    S = len(xs)
    B, tq, D = xs[0].shape
    hd = D // num_heads
    qs = [_heads(linear(p["q"], x), num_heads).float() for p, x in zip(ps, xs)]
    k_blk = [_heads(linear(p["k"], x), num_heads) for p, x in zip(ps, xs)]
    v_blk = [_heads(linear(p["v"], x), num_heads) for p, x in zip(ps, xs)]
    # large-finite start (not -inf): the first block's max always replaces it
    m = [torch.full((B, num_heads, tq, 1), -1e30, device=x.device) for x in xs]
    l_ = [torch.zeros((B, num_heads, tq, 1), device=x.device) for x in xs]
    acc = [torch.zeros((B, tq, num_heads, hd), device=x.device) for x in xs]
    rows = [_mask_rows(mk, i * tq, tq) for i, mk in enumerate(masks)]
    for step in range(S):
        for i in range(S):
            blk = (i - step) % S
            s = torch.einsum("bqhd,bkhd->bhqk", qs[i], k_blk[i].float()) / math.sqrt(hd)
            if rows[i] is not None:
                s = s + rows[i].float()[..., blk * tq:(blk + 1) * tq]
            m_new = torch.maximum(m[i], s.amax(dim=-1, keepdim=True))
            scale = torch.exp(m[i] - m_new)  # the running sums to the new max
            e = torch.exp(s - m_new)
            l_[i] = l_[i] * scale + e.sum(dim=-1, keepdim=True)
            acc[i] = acc[i] * scale.transpose(1, 2) + torch.einsum(
                "bhqk,bkhd->bqhd", e, v_blk[i].float())
            m[i] = m_new
        if step + 1 < S:  # slot i takes the block slot i - 1 held
            k_blk = [move(k_blk[(i - 1) % S], xs[i].device) for i in range(S)]
            v_blk = [move(v_blk[(i - 1) % S], xs[i].device) for i in range(S)]
    return [linear(p["o"], (a / ll.transpose(1, 2)).reshape(B, tq, D).to(x.dtype))
            for p, a, ll, x in zip(ps, acc, l_, xs)]


def sequence_parallel_bert_encoder(mesh: Mesh, num_heads: int, seq_axis: str = "seq",
                                   data_axis: Optional[str] = None,
                                   ring: bool = False) -> Callable:
    """A drop-in for ``models.transformer.bert_encoder`` with the token axis
    split over ``seq_axis``: ``labert_forward(..., encoder_fn=...)``.  The
    output lies on the input's device.

    The ``seq`` axis must divide the token count (LaBERT: 49 image + T
    text); pad the text side with pad ids (attention 0), which changes no
    real row's softmax.  Takes the layer list or a stacked [L, ...] tree;
    ``mask`` None is no mask (zeros)."""
    n_seq = mesh.shape[seq_axis]
    n_rows = mesh.shape[data_axis] if data_axis else 1
    slots = [mesh.axis_slots(seq_axis, r) for r in range(n_rows)]
    attend = _mha_ring if ring else _mha_allgather

    def encoder(layers_params, x, heads, mask):
        del heads  # fixed at build time
        layers = (list(layers_params) if isinstance(layers_params, (list, tuple))
                  else unstack_layers(layers_params))
        B, T = x.shape[:2]
        if T % n_seq:
            raise ValueError(f"token axis {T} not divisible by seq={n_seq}; pad the text "
                             "side (see docstring)")
        if B % n_rows:
            raise ValueError(f"batch {B} not divisible by the data axis ({n_rows})")
        if mask is None:
            mask = torch.zeros((B, 1, 1, T), dtype=x.dtype, device=x.device)
        if mask.shape[0] != B:  # batch-less (e.g. causal) masks
            mask = mask.expand((B,) + tuple(mask.shape[1:]))
        tq, br = T // n_seq, B // n_rows
        copies: dict = {}
        out = []
        for r, devs in enumerate(slots):
            xs = [move(x[r * br:(r + 1) * br, i * tq:(i + 1) * tq], d) for i, d in enumerate(devs)]
            masks = [move(mask[r * br:(r + 1) * br], d) for d in devs]
            for li, p in enumerate(layers):
                ps = []
                for d in devs:
                    if (li, d) not in copies:
                        copies[(li, d)] = _map(lambda a, d=d: a.to(d), p)
                    ps.append(copies[(li, d)])
                att = attend([q["attn"] for q in ps], xs, masks, num_heads)
                xs = [layer_norm(q["attn_ln"], xi + a) for q, xi, a in zip(ps, xs, att)]
                xs = [layer_norm(q["ffn_ln"], xi + ffn(q["ffn"], xi)) for q, xi in zip(ps, xs)]
            out.append(torch.cat([move(xi, x.device) for xi in xs], dim=1))
        return torch.cat(out)

    return encoder


# ------------------------------------------------ expert parallelism ----
def expert_theta_bank(mesh: Mesh, expert_axis: str = "expert") -> Callable:
    """-> ``synth(params, style_embeds [S, E]) -> theta bank`` equal to
    ``train.steps.synthesize_theta_batched`` (each leaf [S, ...], on
    ``style_embeds``'s device): slot e runs the hypernet over rows
    ``[e*S/n, (e+1)*S/n)`` with the hypernet copied onto its device, and the
    blocks are joined.  The expert axis must divide S."""
    from captionax_torch.models.hypernet import hypernet_apply

    slots = mesh.axis_slots(expert_axis, 0)
    n_expert = len(slots)

    def synth(params, style_embeds: torch.Tensor) -> dict:
        S = style_embeds.shape[0]
        if S % n_expert:
            raise ValueError(f"bank size {S} not divisible by expert={n_expert}")
        per = S // n_expert
        copies: dict = {}
        blocks = []
        for e, d in enumerate(slots):
            if d not in copies:
                copies[d] = _map(lambda a: a.to(d), params["hn"])
            blocks.append(hypernet_apply(copies[d], move(style_embeds[e * per:(e + 1) * per], d)))
        return {k: torch.cat([move(b[k], style_embeds.device) for b in blocks])
                for k in blocks[0]}

    return synth
