"""The fused teacher-forced recurrence of training for the H100 — K3, its
forward and its backward (BPTT) — and their plain versions.

Port of ``fused_teacher_forced_hidden`` from
``captionax/ops/train_kernel.py``.  The encoder MLP, ``att1 = W_a f``, h0
and the embedding lookup stay outside the kernels (ordinary autograd); the
T-step attention-GRU recurrence is one ``torch.autograd.Function`` whose
forward and backward are hand-written CUDA kernels
(``csrc/train_recurrence.cu``):

- :func:`fused_fwd`  one launch, ``train_fwd``: a thread-block cluster of C
  CTAs per tile of M = 8 C rows loops over all T steps (replaces
  ``_fwd_kernel``) -> hs [B, T, H] in f32;
- :func:`fused_bwd`  four launches (replace ``_bwd_kernel``):
  :func:`bwd_recurrence` runs ``train_bwd_recurrence`` (the exact BPTT in
  reverse time on the same clusters, each step recomputed from the saved hs;
  the per-row gradients, the attention weights and rounded dctx of every
  step, and for every (step, row) the operands of the weight gradients) and
  ``train_feats_fold`` (:func:`feats_fold`: d_feats, the per-step sum folded
  once per element in the JAX kernel's order, each image's slice of
  regions copied to shared memory once, on the launch of :func:`fold_plan`);
  :func:`wgrad_partial`
  (``train_wgrad_partial``) sums the weight-gradient operands over all T*B
  rows in ``WGRAD_SPLITS`` chunks (X^T dGI, Hprev^T dGH, Hprev^T dATT2 and
  the column sums for the biases); :func:`wgrad_reduce`
  (``train_wgrad_reduce``) adds the chunks, and the per-8-row partials of
  d(v_a), in a fixed order.

The recurrence kernels (design in ``csrc/train_recurrence.cu``): the C CTAs
of a cluster split the H / 8 groups of 8 hidden units (each group's r, z, n
columns and its U_a columns side by side: :func:`pack_recurrence`) and the
rows of the attention, 8 a CTA, and exchange att2, the contexts, h and the
partial sums of dx and dh through distributed shared memory.
:func:`cluster_shape` picks C from what the card reports it can run at once
(:func:`max_clusters`).  bf16 products run on the tensor cores (mma.sync,
one bf16 term per operand: the JAX kernel rounds every product operand to
the compute dtype), f32 products on the CUDA cores.

The weight-gradient pass is 20.6 GFLOP of f32 products at B=1024, T=25,
bound by the f32 FMA rate (0.31 ms at 67 TFLOP/s).  Its kernel is an f32
GEMM for the CUDA cores: 128 x 128 output tiles, an 8 x 8 register tile
per thread read from shared memory as four float4 per 64 FMAs, fed by a
three-stage ring of 16-byte ``cp.async`` copies of 32 rows (every operand
is row-major in the summed rows, so no transpose); the bias row is a ones
row written once into shared memory, and warps whose rows all lie past the
ragged edge skip their FMAs.  ``WGRAD_SPLITS`` = 32 gives 1,088 blocks,
four waves of two blocks per SM.  The JAX kernel takes these products in
f32, so no TF32.

On the TPU the grid runs in order and every tile adds its weight gradients
into one revisited output block.  Hopper's blocks run in parallel in no
order, and d(w_ih) alone (960 KB in f32) exceeds a block's shared memory,
so the cross-block sum is a second pass over rows written to device
memory; its order is fixed, so the gradients are deterministic.

The compute dtype is the dtype of ``raw_features``.  The kernels compute in
f32 and round to the compute dtype where the JAX kernel keeps a value in it
(att2 and the attention temporaries, the context, the operands of the
products, the d_feats / d_att1 accumulators), so the bf16 kernels follow
the same rounding points as the plain versions.  hs is f32.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version (``*_plain``) for CPU tensors only.  The plain backward is the
reverse loop of ``_bwd_kernel`` written out, not autograd.  Like
captionax's kernel, these ignore ``params["layers"]`` (extra GRU layers):
hold them against the scan only at one layer.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from captionax_torch.models import decoder as dec
from captionax_torch.models.layers import embedding, linear
from captionax_torch.ops import _cuda
from captionax_torch.ops._cuda import KernelOp
from captionax_torch.ops.decode_kernel import (
    _SUFFIX,
    GATE_UNITS,
    _check,
    _fragments,
    _launch_device,
    _ptr,
    _sms,
)

# (CTAs a cluster, rows a cluster) of the recurrence kernels, tried in this
# order by cluster_shape: a CTA takes 8 rows of the attention, so M = 8 C
CLUSTER_SHAPES = ((4, 32), (8, 64), (2, 16))
ROWS_PER_CTA = 8
WGRAD_SPLITS = 32       # row chunks of the weight-gradient pass: 1,088 blocks, 4.1 waves

FWD = KernelOp("train_fwd")
BWD = KernelOp("train_bwd_recurrence")
FOLD = KernelOp("train_feats_fold")
WGRAD = KernelOp("train_wgrad_partial")
WGRAD_REDUCE = KernelOp("train_wgrad_reduce")
KERNELS = (FWD, BWD, FOLD, WGRAD, WGRAD_REDUCE)


def cluster_waves(clusters: int, active: int) -> float:
    """The share of ``ceil(clusters / active)`` waves of ``active`` clusters
    that ``clusters`` clusters fill (0 when none can run)."""
    if active < 1:
        return 0.0
    waves = -(-clusters // active)
    return clusters / (waves * active)


def cluster_shape(B: int, active: Dict[int, int]) -> Tuple[int, int]:
    """(C, M) of the recurrence kernels for B rows: the first of
    CLUSTER_SHAPES whose grid of ceil(B / M) clusters fills at least 95% of
    its waves of the ``active[C]`` clusters that the card runs at once
    (``cudaOccupancyMaxActiveClusters``, :func:`max_clusters`; 0 where the
    CTA's shared memory does not fit); otherwise (small B: every grid is one
    wave) the shape with the most CTAs at once, the smaller cluster on a
    tie.  Raises when no shape can run.  A cluster runs its rows' T steps in
    order, so a second wave costs a whole pass again: the H100 runs 30
    clusters of 4 and 15 of 8 at once, so B=1024 takes (2, 16), 64 of 66."""
    runnable = [(c, m) for c, m in CLUSTER_SHAPES if active.get(c, 0) > 0]
    if not runnable:
        raise RuntimeError(f"no cluster shape of the recurrence kernels can run: {active}")
    for c, m in runnable:
        if cluster_waves(-(-B // m), active[c]) >= 0.95:
            return c, m
    return max(runnable, key=lambda s: (min(-(-B // s[1]) * s[0], active[s[0]] * s[0]), -s[0]))


def cta_groups(c: int, C: int, U: int) -> Tuple[int, int]:
    """The unit groups [u0, u1) that CTA c of a cluster of C holds."""
    return c * U // C, (c + 1) * U // C


@functools.lru_cache(maxsize=None)
def max_clusters(dev: torch.device, bwd: bool, bf16: bool, C: int, R: int, F: int, E: int,
                 H: int) -> int:
    """How many clusters of C CTAs of the forward (or pass 1) the card runs
    at once at these sizes (0 when a CTA's shared memory does not fit)."""
    with torch.cuda.device(dev):
        n = _cuda.library().train_recurrence_clusters(int(bwd), int(bf16), C, R, F, E, H)
    if n < 0:
        raise RuntimeError(f"train_recurrence_clusters: CUDA error {-n}")
    return n


def _shape(dev, bwd: bool, cdt, B: int, dims, shape: Optional[int]) -> int:
    """C of a launch: ``shape`` when given, else :func:`cluster_shape`'s."""
    if shape is not None:
        return shape
    active = {c: max_clusters(dev, bwd, cdt == torch.bfloat16, c, *dims) for c, _ in CLUSTER_SHAPES}
    return cluster_shape(B, active)[0]


# the d_feats fold's launch (fold_plan): regions a thread at most (its
# accumulators), threads a block at most, dynamic shared memory a block at
# most (two blocks an SM), and the SMs a plan fills unless told (the H100's)
FOLD_REGIONS = 8
FOLD_THREADS = 384
FOLD_SMEM = 232448 // 2 - 1024
H100_SMS = 132
# waves of the blocks an SM runs at once that a fold grid holds at most: the
# second wave's blocks start as the first's end, so that an SM's blocks
# stagger their loads, folds and stores (PERF.md: at B=1024 this beat one
# wave in f32 and bf16, and an item a block in f32)
FOLD_WAVES = 2


class FoldPlan(NamedTuple):
    """A launch of ``train_feats_fold``.  Item i is image i // (region
    blocks x feature blocks), ``regions`` consecutive regions and ``chunks``
    consecutive 16-byte chunks of features (the last of an image fewer);
    block j takes items j, j + grid, ...  A block's ``threads`` = ``sets`` x
    ``chunks`` threads each hold one chunk of ``per_thread`` consecutive
    regions (thread = set x chunks + chunk).  ``smem``: two buffers, each an
    item's dctx_t (T x chunks x 16 bytes) and w_t (T x sets x per_thread
    floats, each set's rounded up to 16 bytes)."""
    regions: int
    chunks: int
    sets: int
    per_thread: int
    threads: int
    items: int
    grid: int
    smem: int


def _fold_tile(nr: int, nv: int, T: int, sets: int) -> Tuple[int, int, int, int]:
    """(sets, regions a thread, w bytes of a buffer, chunks) of an item of nr
    regions for at least ``sets`` region sets: the chunks as many as the
    threads and the shared memory allow (< 1: none fits)."""
    per = -(-nr // sets)
    sets = -(-nr // per)
    w_bytes = T * sets * -(-per // 4) * 16
    return sets, per, w_bytes, min(nv, FOLD_THREADS // sets, (FOLD_SMEM // 2 - w_bytes) // (T * 16))


def fold_plan(B: int, T: int, R: int, F: int, dtype: torch.dtype, sms: int = H100_SMS,
              resident: Optional[int] = None) -> FoldPlan:
    """The launch of ``train_feats_fold`` for w_t [B, T, R] and dctx_t
    [B, T, F] in ``dtype``.  With B >= ``sms`` images (the card full) an item
    is a whole image and a thread holds the most regions (at most
    FOLD_REGIONS): the fewest shared loads for its products and sums.  With
    fewer, an image's regions are split into ``sms // B`` items, so that
    the items run in one wave, and an item takes as many threads as
    FOLD_THREADS allows: the fewest steps in a thread's chain (at B=64 this
    beat items of 9 regions, two an SM: PERF.md).  An item takes all of its
    image's features unless its threads or its shared memory (at most
    FOLD_SMEM for both buffers) call for feature blocks.  The grid is an
    item a block, or, given ``resident`` (the blocks of this launch that one
    SM runs at once, :func:`fold_resident`), at most FOLD_WAVES waves of
    ``sms`` x ``resident`` blocks, each taking its items in turn.  Raises
    for F % 8 != 0 and where no block fits."""
    if dtype not in _SUFFIX:
        raise ValueError(f"compute dtype {dtype} has no kernel")
    if F % 8 or F < 8 or min(B, T, R) < 1:
        raise ValueError(f"train_feats_fold takes F in multiples of 8 and B, T, R >= 1: B={B}, "
                         f"T={T}, R={R}, F={F}")
    nv = F // (8 if dtype == torch.bfloat16 else 4)   # 16-byte chunks of a row
    nr = R if B >= sms else -(-R // max(1, sms // B))
    fewest = -(-nr // FOLD_REGIONS)
    tiles = [_fold_tile(nr, nv, T, fewest)]
    if B < sms:
        tiles.insert(0, _fold_tile(nr, nv, T, max(fewest, min(nr, FOLD_THREADS // nv))))
    fitting = [t for t in tiles if t[3] >= 1]
    if not fitting:
        raise ValueError(f"train_feats_fold: no block fits T={T}, R={R} (shared memory "
                         f"{FOLD_SMEM} B, {FOLD_THREADS} threads)")
    sets, per, w_bytes, fc = fitting[0]
    fc = -(-nv // -(-nv // fc))                       # the feature blocks evened out
    items = B * -(-R // nr) * -(-nv // fc)
    if items >= 2 ** 31:
        raise ValueError(f"train_feats_fold: {items} items")
    if resident is not None and resident < 1:
        raise ValueError(f"train_feats_fold: no block of {sets * fc} threads fits an SM")
    grid = items if resident is None else min(items, FOLD_WAVES * sms * resident)
    return FoldPlan(nr, fc, sets, per, sets * fc, items, grid, 2 * (T * fc * 16 + w_bytes))


def card_fold_plan(dev: torch.device, B: int, T: int, R: int, F: int,
                   dtype: torch.dtype) -> FoldPlan:
    """The launch of :func:`feats_fold` on the card ``dev``: :func:`fold_plan`
    for its SMs and the blocks of the plan's instance it runs at once."""
    sms = _sms(dev)
    tile = fold_plan(B, T, R, F, dtype, sms)
    return fold_plan(B, T, R, F, dtype, sms,
                     fold_resident(dev, dtype == torch.bfloat16, tile.per_thread, tile.threads,
                                   tile.smem))


@functools.lru_cache(maxsize=None)
def fold_resident(dev: torch.device, bf16: bool, per_thread: int, threads: int,
                  smem: int) -> int:
    """How many blocks of the fold's instance (per_thread regions a thread)
    of ``threads`` threads and ``smem`` bytes one SM of the card runs at once."""
    with torch.cuda.device(dev):
        n = _cuda.library().train_feats_fold_resident(int(bf16), per_thread, threads, smem)
    if n < 0:
        raise RuntimeError(f"train_feats_fold_resident: CUDA error {-n}")
    return n


def pack_recurrence(ua_w: torch.Tensor, wih_t: torch.Tensor, whh_t: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """The weights of the recurrence kernels, each group of GATE_UNITS hidden
    units' columns side by side (group u: columns 8u .. 8u+7 of each gate):
    ``wx`` [In, U * 24] = w_ih^T's r, z, n columns; ``wh`` [H, U * 32] =
    w_hh^T's r, z, n and U_a's columns; ``wxr`` [U * 32, In] = [w_ih^T's r,
    z, n | 0]^T and ``whr`` = wh^T, the products of the other direction.  A
    CTA holding groups [u0, u1) reads columns u0 * 24 .. or 32 .. of wx and
    wh and rows 32 u0 .. of wxr and whr.  bf16 weights come as mma.sync B
    fragments of those matrices (:func:`decode_kernel._fragments`: [k16
    tiles, n8 tiles, 32, 4]); f32 as they are.  H must be a multiple of 8."""
    In, G = wih_t.shape
    H = whh_t.shape[0]
    U = H // GATE_UNITS
    gx = wih_t.reshape(In, 3, U, GATE_UNITS)
    gh = torch.cat([whh_t.reshape(H, 3, U, GATE_UNITS), ua_w.reshape(H, 1, U, GATE_UNITS)],
                   dim=1)
    wx = gx.permute(0, 2, 1, 3).reshape(In, U * 24)
    wh = gh.permute(0, 2, 1, 3).reshape(H, U * 32)
    wxr = torch.cat([gx, torch.zeros_like(gx[:, :1])], dim=1).permute(0, 2, 1, 3).reshape(
        In, U * 32).t()
    whr = wh.t()
    mats = {"wx": wx, "wh": wh, "wxr": wxr, "whr": whr}
    if wih_t.dtype == torch.bfloat16:
        return {k: _fragments(m).contiguous() for k, m in mats.items()}
    return {k: m.contiguous() for k, m in mats.items()}


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 product of the operands' values (``preferred_element_type``)."""
    return torch.matmul(a.float(), b.float())


def _word(embeds: torch.Tensor, t: int) -> torch.Tensor:
    """The word consumed at step t: zeros at t=0, else embeds[:, t-1], f32."""
    if t == 0:
        return torch.zeros_like(embeds[:, 0], dtype=torch.float32)
    return embeds[:, t - 1].float()


def _cell(word, h, feats, att1, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """One attention + GRU step from h (f32), as ``_cell_fwd``; the
    intermediates the backward needs come back too."""
    cdt = feats.dtype
    hd = h.shape[1]
    att2 = _dot32(h.to(cdt), ua_w) + ua_b
    a = torch.tanh(att1 + att2[:, None, :].to(cdt))                 # [rows, R, H]
    s = torch.sum(a * va.to(cdt), dim=2).float()
    s = s - s.max(dim=1, keepdim=True).values
    w = torch.exp(s)
    w = w / w.sum(dim=1, keepdim=True)                              # [rows, R] f32
    ctx = torch.sum(w.to(cdt)[:, :, None] * feats, dim=1).float()
    x = torch.cat([word, ctx], dim=1)
    gi = _dot32(x.to(cdt), wih_t) + bih
    gh = _dot32(h.to(cdt), whh_t) + bhh
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    gh_n = gh[:, 2 * hd:]
    n = torch.tanh(gi[:, 2 * hd:] + r * gh_n)
    return (1.0 - z) * n + z * h, (a, w, x, r, z, n, gh_n)


# ====================================================================
# the plain versions
# ====================================================================
def fused_fwd_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """feats [B, R, F] and att1 [B, R, H] in the compute dtype, h0 [B, H],
    embeds [B, T, E] (unshifted), U_a [H, H], w_ih^T [E+F, 3H], w_hh^T
    [H, 3H] in the compute dtype; biases and v_a [H] -> hs [B, T, H] f32."""
    h = h0.float()
    hs = []
    for t in range(embeds.shape[1]):
        h, _ = _cell(_word(embeds, t), h, feats, att1, ua_w, ua_b, va, wih_t, whh_t,
                     bih, bhh)
        hs.append(h)
    return torch.stack(hs, dim=1)


def bwd_recurrence_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh,
                         hs, g, fold_operands: bool = False):
    """Pass 1 of the BPTT of :func:`fused_fwd_plain` for the cotangent g
    [B, T, H] of hs: the reverse loop of ``_bwd_kernel``, each step
    recomputed from h_{t-1}.  -> (d_feats, d_att1, d_h0, d_emb, rows, dva_part):
    d_feats and d_att1 accumulated in the compute dtype, d_h0 and d_emb
    (already shifted back one step) in f32, and ``rows``, the operands of
    the weight gradients for row n = t*B + b, in f32: ``x`` [N, E+F] (the
    word and the context), ``dgi`` [N, 3H], ``hp`` [N, H] (h_{t-1}),
    ``dghn`` [N, H] (the n-gate part of dgh) and ``datt2`` [N, H]; d(v_a) as
    one partial per ROWS_PER_CTA rows [ceil(B / 8), H], as the kernel gives
    them (a CTA's rows of the attention).  With ``fold_operands`` a seventh
    item: (w_t [B, T, R] f32, dctx_t [B, T, F] in the compute dtype), the
    attention weights and rounded dctx of every step, whose
    :func:`feats_fold_plain` is d_feats."""
    cdt = feats.dtype
    B, R, F = feats.shape
    T, E = embeds.shape[1], embeds.shape[2]
    H = h0.shape[1]
    dev = feats.device
    va_c = va.to(cdt)
    nb = -(-B // ROWS_PER_CTA)
    d_va = torch.zeros((nb * ROWS_PER_CTA, H), dtype=torch.float32, device=dev)
    d_feats = torch.zeros((B, R, F), dtype=cdt, device=dev)
    d_att1 = torch.zeros((B, R, H), dtype=cdt, device=dev)
    d_emb = torch.zeros((B, T, E), dtype=torch.float32, device=dev)
    dh = torch.zeros((B, H), dtype=torch.float32, device=dev)
    w_t = torch.zeros((B, T, R), dtype=torch.float32, device=dev)
    dctx_t = torch.zeros((B, T, F), dtype=cdt, device=dev)
    rows = {k: [None] * T for k in ("x", "dgi", "hp", "dghn", "datt2")}
    for t in reversed(range(T)):
        h_prev = h0.float() if t == 0 else hs[:, t - 1].float()
        _, (a, w, x, r, z, n, gh_n) = _cell(_word(embeds, t), h_prev, feats, att1, ua_w,
                                            ua_b, va, wih_t, whh_t, bih, bhh)
        dh_new = g[:, t].float() + dh
        dz = dh_new * (h_prev - n)
        dn = dh_new * (1.0 - z)
        dh_prev = dh_new * z
        dpre_n = dn * (1.0 - n * n)
        dr = dpre_n * gh_n
        dpre_r = dr * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dghn = dpre_n * r
        dgh = torch.cat([dpre_r, dpre_z, dghn], dim=1)
        dx = _dot32(dgi.to(cdt), wih_t.t())
        dh_prev = dh_prev + _dot32(dgh.to(cdt), whh_t.t())
        if t > 0:  # the zero word of step 0 has no embedding to receive it
            d_emb[:, t - 1] = dx[:, :E]
        dctx3 = dx[:, None, E:].to(cdt)
        w_t[:, t], dctx_t[:, t] = w, dctx3[:, 0]
        dw = torch.sum(dctx3 * feats, dim=2).float()
        d_feats = d_feats + w.to(cdt)[:, :, None] * dctx3
        ds = w * (dw - torch.sum(w * dw, dim=1, keepdim=True))
        da = ds.to(cdt)[:, :, None] * va_c
        de_lin = da * (1.0 - a * a)
        d_att1 = d_att1 + de_lin
        datt2 = torch.sum(de_lin, dim=1).float()
        d_va[:B] += torch.sum(a.float() * ds[:, :, None], dim=1)
        dh = dh_prev + _dot32(datt2.to(cdt), ua_w.t())
        for k, v in (("x", x), ("dgi", dgi), ("hp", h_prev), ("dghn", dghn),
                     ("datt2", datt2)):
            rows[k][t] = v
    rows = {k: torch.cat(v, dim=0) for k, v in rows.items()}
    dva_part = d_va.view(nb, ROWS_PER_CTA, H).sum(dim=1)
    out = (d_feats, d_att1, dh, d_emb, rows, dva_part)
    return out + ((w_t, dctx_t),) if fold_operands else out


def feats_fold_plain(w_t: torch.Tensor, dctx_t: torch.Tensor) -> torch.Tensor:
    """d_feats [B, R, F] in dctx_t's dtype from the attention weights w_t
    [B, T, R] (f32) and the rounded dctx_t [B, T, F] of every step: the
    fold over t = T-1 .. 0 of d <- d + rnd(w_t) dctx_t in that dtype, the
    order and roundings of pass 1's per-step sum."""
    cdt = dctx_t.dtype
    B, T, R = w_t.shape
    d = torch.zeros((B, R, dctx_t.shape[2]), dtype=cdt, device=dctx_t.device)
    for t in reversed(range(T)):
        d = d + w_t[:, t].to(cdt)[:, :, None] * dctx_t[:, t][:, None, :]
    return d


def wgrad_plain(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The weight gradients summed over the given rows, in the layout of
    :func:`wgrad_layout` — [x | 1]^T dgi, [hp | 1]^T [dgi_rz | dghn] and
    [hp | 1]^T datt2, flattened and concatenated (f32)."""
    ones = lambda a: torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
    hp1 = ones(rows["hp"])
    H = rows["hp"].shape[1]
    dgh = torch.cat([rows["dgi"][:, :2 * H], rows["dghn"]], dim=1)
    return torch.cat([(ones(rows["x"]).t() @ rows["dgi"]).reshape(-1),
                      (hp1.t() @ dgh).reshape(-1), (hp1.t() @ rows["datt2"]).reshape(-1)])


def _chunks(n: int, splits: int):
    """The row ranges of the weight-gradient pass's chunks."""
    per = -(-n // splits)
    return [(min(n, q * per), min(n, (q + 1) * per)) for q in range(splits)]


def wgrad_partial_plain(rows: Dict[str, torch.Tensor]):
    """Pass 2a: :func:`wgrad_plain` of each of the WGRAD_SPLITS chunks of
    rows -> [WGRAD_SPLITS, total]."""
    return torch.stack([wgrad_plain({k: v[a:b] for k, v in rows.items()})
                        for a, b in _chunks(rows["x"].shape[0], WGRAD_SPLITS)])


def wgrad_reduce_plain(partial: torch.Tensor, dva_part: torch.Tensor):
    """Pass 2b: the chunks' sum and the 8-row blocks' d(v_a), each added in order."""
    out, d_va = partial[0].clone(), dva_part[0].clone()
    for x in partial[1:]:
        out += x
    for x in dva_part[1:]:
        d_va += x
    return out, d_va


def _split_wgrads(out: torch.Tensor, In: int, H: int):
    """(d_wih, d_bih, d_whh, d_bhh, d_ua_w, d_ua_b): views of pass 2's output."""
    parts = []
    for name in ("wih", "whh", "ua"):
        off, r, c = wgrad_layout(In, H)[name]
        m = out[off:off + r * c].view(r, c)
        parts += [m[:-1], m[-1]]
    return parts


def wgrad_layout(In: int, H: int) -> Dict[str, Tuple[int, int, int]]:
    """Where each weight gradient sits in the output of the weight-gradient
    pass: name -> (offset, rows, columns).  Each product carries one more
    row, the column sums: the bias gradient beside the weight's."""
    G = 3 * H
    o1 = (In + 1) * G
    o2 = o1 + (H + 1) * G
    return {"wih": (0, In + 1, G), "whh": (o1, H + 1, G), "ua": (o2, H + 1, H),
            "total": (o2 + (H + 1) * H, 0, 0)}


def _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va):
    """The eleven gradients, each in its input's dtype, from the passes'
    outputs."""
    feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh = args
    d_wih, d_bih, d_whh, d_bhh, d_ua_w, d_ua_b = _split_wgrads(out, wih_t.shape[0],
                                                               h0.shape[1])
    return (d_feats.to(feats.dtype), d_att1.to(att1.dtype), d_h0.to(h0.dtype),
            d_emb.to(embeds.dtype), d_ua_w.to(ua_w.dtype), d_ua_b.to(ua_b.dtype),
            d_va.to(va.dtype), d_wih.to(wih_t.dtype), d_whh.to(whh_t.dtype),
            d_bih.to(bih.dtype), d_bhh.to(bhh.dtype))


def fused_bwd_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh,
                    hs, g):
    """The exact BPTT of :func:`fused_fwd_plain`: pass 1
    (:func:`bwd_recurrence_plain`), then pass 2 (:func:`wgrad_partial_plain`,
    :func:`wgrad_reduce_plain`).  -> the gradients of the eleven inputs,
    each in its input's dtype; the weight gradients are summed in f32."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    d_feats, d_att1, d_h0, d_emb, rows, dva_part = bwd_recurrence_plain(*args, hs, g)
    out, d_va = wgrad_reduce_plain(wgrad_partial_plain(rows), dva_part)
    return _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va)


# ====================================================================
# the kernels' wrappers
# ====================================================================
def _operands(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """The kernels' operands: feats, att1 and the three weight matrices in
    the compute dtype as given; h0, embeds, the biases and v_a widened to
    f32 (exact), all contiguous."""
    c = lambda x: x.contiguous()
    f = lambda x: x.float().contiguous()
    return (c(feats), c(att1), f(h0), f(embeds), c(ua_w), f(ua_b), f(va), c(wih_t),
            c(whh_t), f(bih), f(bhh))


def _check_operands(ops):
    """Device, compute dtype and sizes (B, T, R, F, E, H) of a launch, or raise."""
    feats = ops[0]
    dev = _launch_device(feats)
    cdt = feats.dtype
    if cdt not in _SUFFIX:
        raise ValueError(f"compute dtype {cdt} has no kernel")
    B, R, F = feats.shape
    T, E = ops[3].shape[1], ops[3].shape[2]
    H = ops[2].shape[1]
    f32 = torch.float32
    for name, x, dt, shape in zip(
        ("feats", "att1", "h0", "embeds", "ua_w", "ua_b", "va", "wih_t", "whh_t",
         "bih", "bhh"), ops,
        (cdt, cdt, f32, f32, cdt, f32, f32, cdt, cdt, f32, f32),
        ((B, R, F), (B, R, H), (B, H), (B, T, E), (H, H), (H,), (H,), (E + F, 3 * H),
         (H, 3 * H), (3 * H,), (3 * H,)),
    ):
        _check(x, name, dev, dt, shape)
    if B == 0 or T == 0:
        raise ValueError("empty batch or sequence")
    return dev, cdt, (B, T, R, F, E, H)


# the widest F and H of the recurrence kernels (a lane holds at most two
# 16-byte chunks of an att1 or feats row)
MAX_WIDTH = 256
# `skip` bits of the recurrence kernels, for timing their parts (the output
# is then not the function): the attention (scores, softmax, context), the
# h and x products with the GRU (and its backward), the dx and dh products
# with their sums across the cluster, the attention backward; and of the
# attention, the scores alone and the context alone
SKIP_ATTENTION, SKIP_GATES, SKIP_REVERSE, SKIP_ATTENTION_BACK = 1, 2, 4, 8
SKIP_SCORES, SKIP_CONTEXT = 16, 32
# `skip` bits of the fold: the arithmetic (zeros are stored), the copies of
# its operands from device memory to shared memory, the stores of d_feats
FOLD_SKIP_ARITH, FOLD_SKIP_STAGE, FOLD_SKIP_STORE = 1, 2, 4


def _check_widths(F: int, E: int, H: int) -> None:
    if F % 8 or E % 8 or H % 8 or F > MAX_WIDTH or H > MAX_WIDTH:
        raise ValueError(f"the recurrence kernels take F, E and H in multiples of 8 (16-byte "
                         f"rows, groups of 8 units), F and H up to {MAX_WIDTH}: F={F}, E={E}, "
                         f"H={H}")


def fused_fwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh,
              shape: Optional[int] = None, skip: int = 0) -> torch.Tensor:
    """K3's forward: ``train_fwd`` on the card, the plain version for CPU
    tensors.  -> hs [B, T, H] f32.  ``shape`` forces the CTAs a cluster
    (2, 4 or 8; default :func:`cluster_shape`'s); ``skip`` (SKIP_* bits)
    leaves parts out, to time them."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    if feats.device.type == "cpu":
        return fused_fwd_plain(*args)
    ops = _operands(*args)
    dev, cdt, (B, T, R, F, E, H) = _check_operands(ops)
    _check_widths(F, E, H)
    C = _shape(dev, False, cdt, B, (R, F, E, H), shape)
    pk = pack_recurrence(ops[4], ops[7], ops[8])
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FWD.launch(f"train_fwd_{_SUFFIX[cdt]}",
                   *(_ptr(ops[i]) for i in (0, 1, 2, 3, 5, 6, 9, 10)),
                   _ptr(pk["wx"]), _ptr(pk["wh"]), _ptr(hs), B, T, R, F, E, H, C, skip,
                   torch.cuda.current_stream(dev).cuda_stream)
    return hs


def bwd_recurrence_parts(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh, hs,
                         g, shape: Optional[int] = None, skip: int = 0):
    """``train_bwd_recurrence`` alone (CUDA tensors only): -> ((w_t, dctx_t),
    d_att1, d_h0, d_emb, rows, dva_part), the fold's operands in place of
    d_feats (:func:`feats_fold`).  ``shape`` and ``skip`` as for
    :func:`fused_fwd`."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    ops = _operands(*args)
    dev, cdt, (B, T, R, F, E, H) = _check_operands(ops)
    _check_widths(F, E, H)
    hs, g = hs.contiguous(), g.float().contiguous()
    _check(hs, "hs", dev, torch.float32, (B, T, H))
    _check(g, "g", dev, torch.float32, (B, T, H))
    C = _shape(dev, True, cdt, B, (R, F, E, H), shape)
    pk = pack_recurrence(ops[4], ops[7], ops[8])
    In, N = E + F, T * B
    f32 = dict(dtype=torch.float32, device=dev)
    d_att1 = torch.empty((B, R, H), dtype=cdt, device=dev)
    d_h0 = torch.empty((B, H), **f32)
    d_emb = torch.empty((B, T, E), **f32)
    rows = {"x": torch.empty((N, In), **f32), "dgi": torch.empty((N, 3 * H), **f32),
            "hp": torch.empty((N, H), **f32), "dghn": torch.empty((N, H), **f32),
            "datt2": torch.empty((N, H), **f32)}
    dva_part = torch.empty((-(-B // ROWS_PER_CTA), H), **f32)
    w_t = torch.empty((B, T, R), **f32)
    dctx_t = torch.empty((B, T, F), dtype=cdt, device=dev)
    with torch.cuda.device(dev):
        BWD.launch(f"train_bwd_recurrence_{_SUFFIX[cdt]}",
                   *(_ptr(ops[i]) for i in (0, 1, 2, 3, 5, 6, 9, 10)),
                   *(_ptr(pk[k]) for k in ("wx", "wh", "wxr", "whr")), _ptr(hs), _ptr(g),
                   _ptr(d_att1), _ptr(d_h0), _ptr(d_emb),
                   *(_ptr(rows[k]) for k in ("x", "dgi", "hp", "dghn", "datt2")),
                   _ptr(dva_part), _ptr(w_t), _ptr(dctx_t), B, T, R, F, E, H, C, skip,
                   torch.cuda.current_stream(dev).cuda_stream)
    return (w_t, dctx_t), d_att1, d_h0, d_emb, rows, dva_part


def feats_fold(w_t: torch.Tensor, dctx_t: torch.Tensor, skip: int = 0) -> torch.Tensor:
    """d_feats from pass 1's fold operands: ``train_feats_fold`` on the
    card, on the launch of :func:`fold_plan`; :func:`feats_fold_plain` for
    CPU tensors.  ``skip`` (FOLD_SKIP_* bits) leaves parts out, to time
    them."""
    if w_t.device.type == "cpu":
        return feats_fold_plain(w_t, dctx_t)
    dev = _launch_device(w_t)
    cdt = dctx_t.dtype
    if cdt not in _SUFFIX:
        raise ValueError(f"compute dtype {cdt} has no kernel")
    B, T, R = w_t.shape
    F = dctx_t.shape[2]
    _check(w_t, "w_t", dev, torch.float32, (B, T, R))
    _check(dctx_t, "dctx_t", dev, cdt, (B, T, F))
    plan = card_fold_plan(dev, B, T, R, F, cdt)
    d_feats = torch.empty((B, R, F), dtype=cdt, device=dev)
    with torch.cuda.device(dev):
        FOLD.launch(f"train_feats_fold_{_SUFFIX[cdt]}", _ptr(w_t), _ptr(dctx_t), _ptr(d_feats),
                    B, T, R, F, plan.regions, plan.chunks, plan.sets, plan.grid, plan.smem,
                    skip, torch.cuda.current_stream(dev).cuda_stream)
    return d_feats


def bwd_recurrence(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh, hs, g,
                   shape: Optional[int] = None):
    """K3's backward, pass 1: ``train_bwd_recurrence`` and
    ``train_feats_fold`` on the card, the plain version for CPU tensors.
    -> (d_feats, d_att1, d_h0, d_emb, rows, dva_part) as
    :func:`bwd_recurrence_plain` gives them."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    if feats.device.type == "cpu":
        return bwd_recurrence_plain(*args, hs, g)
    fold_ops, *rest = bwd_recurrence_parts(*args, hs, g, shape=shape)
    return (feats_fold(*fold_ops), *rest)


def wgrad_partial(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K3's backward, pass 2a: ``train_wgrad_partial`` on the card, the plain
    version for CPU tensors.  -> [WGRAD_SPLITS, total] partial weight
    gradients, one per chunk of rows."""
    x = rows["x"]
    if x.device.type == "cpu":
        return wgrad_partial_plain(rows)
    dev = _launch_device(x)
    N, In = x.shape
    H = rows["hp"].shape[1]
    for k, w in (("x", In), ("dgi", 3 * H), ("hp", H), ("dghn", H), ("datt2", H)):
        _check(rows[k], k, dev, torch.float32, (N, w))
    if N == 0:
        raise ValueError("no rows")
    if In % 4 or H % 4:
        raise ValueError(f"train_wgrad_partial copies 16 bytes: In={In} and H={H} must be "
                         "multiples of 4")
    partial = torch.empty((WGRAD_SPLITS, wgrad_layout(In, H)["total"][0]), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        WGRAD.launch("train_wgrad_partial",
                     *(_ptr(rows[k]) for k in ("x", "dgi", "hp", "dghn", "datt2")),
                     _ptr(partial), N, In, H, WGRAD_SPLITS,
                     torch.cuda.current_stream(dev).cuda_stream)
    return partial


def wgrad_reduce(partial: torch.Tensor, dva_part: torch.Tensor):
    """K3's backward, pass 2b: ``train_wgrad_reduce`` on the card, the plain
    version for CPU tensors.  -> (the weight gradients [total], d(v_a) [H])."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, dva_part)
    dev = _launch_device(partial)
    splits, total = partial.shape
    n_blocks, H = dva_part.shape
    _check(partial, "partial", dev, torch.float32, (splits, total))
    _check(dva_part, "dva_part", dev, torch.float32, (n_blocks, H))
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    d_va = torch.empty((H,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        WGRAD_REDUCE.launch("train_wgrad_reduce", _ptr(partial), _ptr(out), total, splits,
                            _ptr(dva_part), _ptr(d_va), n_blocks, H,
                            torch.cuda.current_stream(dev).cuda_stream)
    return out, d_va


def fused_bwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh, hs, g):
    """K3's backward: :func:`bwd_recurrence`, :func:`wgrad_partial`,
    :func:`wgrad_reduce` (four launches on the card, the plain versions
    for CPU tensors).  -> the gradients of the eleven inputs of
    :func:`fused_fwd`, each in its input's dtype."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    d_feats, d_att1, d_h0, d_emb, rows, dva_part = bwd_recurrence(*args, hs, g)
    out, d_va = wgrad_reduce(wgrad_partial(rows), dva_part)
    return _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va)


class FusedRecurrence(torch.autograd.Function):
    """hs = the T-step recurrence of (feats, att1, h0, embeds, U_a w, U_a b,
    v_a, w_ih^T, w_hh^T, b_ih, b_hh); forward :func:`fused_fwd`, backward
    :func:`fused_bwd` from the saved hs."""

    @staticmethod
    def forward(ctx, feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
        hs = fused_fwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
        ctx.save_for_backward(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t,
                              bih, bhh, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        return fused_bwd(*ctx.saved_tensors, g)


def core_inputs(params: Dict, raw_features: torch.Tensor, captions: torch.Tensor,
                gru_params: Optional[Dict] = None) -> Tuple[torch.Tensor, ...]:
    """The eleven inputs of :class:`FusedRecurrence`, computed outside the
    kernels with ordinary autograd: the encoded features, att1 = W_a f and
    U_a, w_ih^T, w_hh^T in the compute dtype (``raw_features.dtype``), h0,
    the embeddings of the captions, U_a's bias, v_a and the GRU biases."""
    features = dec.encode_features(params, raw_features)
    h0 = dec.init_hidden(params, features)
    att = params["attention"]
    att1 = linear(att["W_a"], features)
    embeds = embedding(params["embed"], captions.long())
    cell = params["gru"] if gru_params is None else gru_params
    cdt = raw_features.dtype
    return (features.to(cdt), att1.to(cdt), h0, embeds, att["U_a"]["w"].to(cdt),
            att["U_a"]["b"], att["v_a"]["w"][:, 0], cell["w_ih"].t().to(cdt),
            cell["w_hh"].t().to(cdt), cell["b_ih"], cell["b_hh"])


def fused_teacher_forced_hidden(params: Dict, raw_features: torch.Tensor,
                                captions: torch.Tensor,
                                gru_params: Optional[Dict] = None) -> Tuple[torch.Tensor, None]:
    """Drop-in for ``teacher_forced_hidden(...)[0]`` under pure teacher
    forcing, with the recurrence on K3.  Differentiable in every decoder
    and theta tensor; the attention weights are not produced (the loss never
    reads them).  d(v_a bias) is exactly 0 (softmax shift invariance).  The
    compute dtype is ``raw_features.dtype``; hs is f32.  Runs where the
    tensors are: the kernels on the card, their plain versions on the CPU."""
    return FusedRecurrence.apply(*core_inputs(params, raw_features, captions, gru_params)), None
