"""The launch plan of K3's d_feats fold ``train_feats_fold``
(captionax_torch/ops/train_kernel.py ``fold_plan``, csrc/train_recurrence.cu),
on the CPU.

- ``fold_plan`` over B in {1, 3, 64, 1024}, T in {1, 25, 64}, R in {1, 9,
  49}, F in {8, 24, 200, 2048}, f32 and bf16, an item a block and at most
  2 or 3 blocks an SM: its items, cut as the kernel cuts them (item ->
  image, region block, feature block; block j -> items j, j + grid, ...;
  thread -> region set and chunk; a thread's regions set x per_thread + k),
  cover every (image, region, 16-byte chunk of features) exactly once; its
  dynamic shared memory is the kernel's two buffers and stays within a
  block's 227 KB; an item is a whole image once B fills the H100's 132
  SMs, and below that the items run in one wave and fill at least half of
  the SMs wherever B x R allows; it raises for F % 8 != 0;
- a numpy emulation of the kernel on a plan (each block's items in turn
  through two shared-memory buffers that keep what the item before left
  (NaN at first, so that a read of a slot never written shows); the
  staging copies with their alignments, w into each set's 16-byte-aligned
  slots; bf16 w rounded once; each
  thread's accumulators folded in t = T-1 .. 0 order in the compute dtype)
  equals ``feats_fold_plain`` by ``torch.equal``, at chip_smoke.py's
  FOLD_EDGE shapes (T R odd, where the w_t rows of odd images are off 16
  bytes, among them), at plans with a whole image's regions an item, and
  with blocks that take several items;
- on a card (marker ``cuda``), the kernel equals its plain version at the
  same shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from captionax_torch.ops import train_kernel as tk

torch.set_num_threads(1)

H100_SMS = 132
H100_SMEM = 232448   # a block's shared memory on the H100 (227 KB)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _chunk(dtype) -> int:
    """Features in a 16-byte chunk."""
    return 8 if dtype == torch.bfloat16 else 4


def _items(plan, B, R, nv):
    """Each item's (image, first region, regions, first chunk, chunks), as
    the kernel derives them from its index."""
    nrb, nfb = -(-R // plan.regions), -(-nv // plan.chunks)
    i = np.arange(plan.items)
    fb, rb, b = i % nfb, (i // nfb) % nrb, i // (nfb * nrb)
    r0, c0 = rb * plan.regions, fb * plan.chunks
    return b, r0, np.minimum(plan.regions, R - r0), c0, np.minimum(plan.chunks, nv - c0)


def _thread_cover(plan, nrl, fcl):
    """(local region, chunk) -> how many threads of a block of nrl regions
    and fcl chunks write it."""
    cover = np.zeros((nrl, fcl), dtype=np.int64)
    for tid in range(plan.threads):
        s, c = divmod(tid, plan.chunks)
        if c >= fcl:
            continue
        for k in range(plan.per_thread):
            if s * plan.per_thread + k < nrl:
                cover[s * plan.per_thread + k, c] += 1
    return cover


def _w_bytes(T, plan) -> int:
    """A buffer's w rows: each set's per_thread slots rounded up to 16 bytes."""
    return T * plan.sets * -(-plan.per_thread // 4) * 16


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F", [8, 24, 200, 2048])
@pytest.mark.parametrize("R", [1, 9, 49])
@pytest.mark.parametrize("T", [1, 25, 64])
@pytest.mark.parametrize("B", [1, 3, 64, 1024])
def test_fold_plan_covers_each_element_once(B, T, R, F, dtype):
    cdt = DTYPES[dtype]
    plan = tk.fold_plan(B, T, R, F, cdt)
    nv = F // _chunk(cdt)
    assert plan.threads == plan.sets * plan.chunks <= tk.FOLD_THREADS
    assert plan.per_thread == -(-plan.regions // plan.sets) <= tk.FOLD_REGIONS
    assert plan.smem == 2 * (T * plan.chunks * 16 + _w_bytes(T, plan))
    assert plan.smem <= H100_SMEM
    n_feature_blocks = -(-nv // plan.chunks)
    assert plan.items == B * -(-R // plan.regions) * n_feature_blocks == plan.grid
    if B >= H100_SMS:
        assert plan.regions == R
    else:
        assert plan.items <= H100_SMS * n_feature_blocks
    assert plan.grid >= min(H100_SMS // 2, B * R)
    for resident in (2, 3):
        bounded = tk.fold_plan(B, T, R, F, cdt, resident=resident)
        assert bounded._replace(grid=plan.grid) == plan
        assert bounded.grid == min(plan.items, tk.FOLD_WAVES * H100_SMS * resident)
        assert bounded.grid >= min(H100_SMS // 2, B * R)
    b, r0, nrl, c0, fcl = _items(plan, B, R, nv)
    assert (nrl >= 1).all() and (fcl >= 1).all()
    cover = np.zeros((B, R, nv), dtype=np.uint8)
    for i in range(plan.items):
        cover[b[i], r0[i]:r0[i] + nrl[i], c0[i]:c0[i] + fcl[i]] += 1
    assert (cover == 1).all()
    for n_r, n_c in set(zip(nrl.tolist(), fcl.tolist())):
        assert (_thread_cover(plan, n_r, n_c) == 1).all()


@pytest.mark.parametrize("F", [4, 12, 20, 201, 0])
def test_fold_plan_raises_for_f_off_8(F):
    for cdt in DTYPES.values():
        with pytest.raises(ValueError, match="multiples of 8"):
            tk.fold_plan(64, 25, 49, F, cdt)


def test_fold_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no kernel"):
        tk.fold_plan(64, 25, 49, 200, torch.float16)
    with pytest.raises(ValueError, match="no block fits"):
        tk.fold_plan(1024, 4096, 49, 200, torch.float32)  # w alone past the shared memory
    with pytest.raises(ValueError, match="fits an SM"):
        tk.fold_plan(64, 25, 49, 200, torch.float32, resident=0)


def test_fold_plan_at_full_width():
    """B=1024, T=25, R=49, F=200: an item an image (its 49 regions, all its
    features), 7 regions a thread, at most two waves of the blocks an SM
    runs; at the training batch of 64, two items an image (25 and 24
    regions), one wave, 350 threads an item (f32: 4 regions a thread; bf16:
    2)."""
    f32 = tk.fold_plan(1024, 25, 49, 200, torch.float32)
    bf16 = tk.fold_plan(1024, 25, 49, 200, torch.bfloat16)
    assert f32 == tk.FoldPlan(49, 50, 7, 7, 350, 1024, 1024, 2 * (20000 + 5600))
    assert bf16 == tk.FoldPlan(49, 25, 7, 7, 175, 1024, 1024, 2 * (10000 + 5600))
    assert tk.fold_plan(1024, 25, 49, 200, torch.float32, resident=2).grid == 528
    assert tk.fold_plan(1024, 25, 49, 200, torch.bfloat16, resident=5).grid == 1024
    assert tk.fold_plan(64, 25, 49, 200, torch.float32) == tk.FoldPlan(
        25, 50, 7, 4, 350, 128, 128, 2 * (20000 + 2800))
    assert tk.fold_plan(64, 25, 49, 200, torch.bfloat16) == tk.FoldPlan(
        25, 25, 13, 2, 325, 128, 128, 2 * (10000 + 5200))


def _rnd(x: np.ndarray, cdt) -> np.ndarray:
    """x rounded to the compute dtype (as f32 values)."""
    return torch.from_numpy(x).to(cdt).float().numpy()


def _each_tc(T: int, n: int, tid: int, nth: int):
    """The kernel's for_each_tc: (e // n, e % n) for e = tid, tid + nth, ...
    < T n, stepped without a division an element."""
    if n <= 0:
        return
    t, c = divmod(tid, n)
    dt, dc = divmod(nth, n)
    while t < T:
        yield t, c
        t, c = t + dt, c + dc
        if c >= n:
            t, c = t + 1, c - n


def test_each_tc_steps_as_divmod():
    for T, n, nth in ((1, 1, 1), (25, 50, 350), (25, 49, 175), (64, 52, 384), (3, 7, 2),
                      (25, 300, 50), (2, 1, 384)):
        for tid in range(nth):
            assert list(_each_tc(T, n, tid, nth)) == [divmod(e, n)
                                                      for e in range(tid, T * n, nth)]


def emulate_fold(w_t: torch.Tensor, dctx_t: torch.Tensor, plan) -> torch.Tensor:
    """The kernel on ``plan``, block by block: its items in turn through two
    buffers that keep what the item before left in them; the copies to
    shared memory as it issues them (16-byte copies of dctx, 4-byte copies
    of w into each set's 16-byte-aligned slots, each thread's in the order
    of its for_each_tc, from flat arrays, their alignment checked); each
    thread's P x V accumulators folded over t = T-1
    .. 0 in the compute dtype from its set's slots; its stores."""
    cdt = dctx_t.dtype
    B, T, R = w_t.shape
    F = dctx_t.shape[2]
    V, elt = _chunk(cdt), dctx_t.element_size()
    P, S = plan.per_thread, plan.sets
    nv, sw = F // V, 4 * -(-P // 4)          # sw: a set's w slots
    w_flat = w_t.reshape(-1).numpy()
    x_flat = dctx_t.reshape(-1)
    out = torch.full((B * R * F,), float("nan"), dtype=cdt)
    items = _items(plan, B, R, nv)
    for block in range(plan.grid):
        bufs = [(torch.full((T, plan.chunks * V), float("nan"), dtype=cdt),
                 np.full((T, S * sw), np.nan, dtype=np.float32)) for _ in range(2)]
        for n, i in enumerate(range(block, plan.items, plan.grid)):
            b, r0, nrl, c0, fcl = (int(a[i]) for a in items)
            ds, ws = bufs[n % 2]
            for tid in range(plan.threads):
                for t, c in _each_tc(T, fcl, tid, plan.threads):
                    src = b * T * F + t * F + (c0 + c) * V
                    assert (src * elt) % 16 == 0
                    ds[t, c * V:(c + 1) * V] = x_flat[src:src + V]
                for t, r in _each_tc(T, nrl, tid, plan.threads):
                    ws[t, r // P * sw + r % P] = w_flat[b * T * R + t * R + r0 + r]
            if cdt == torch.bfloat16:
                ws[:] = _rnd(ws, cdt)
            # thread (s, c) folds regions s P .. s P + P - 1 from slots s sw ..
            rows = torch.from_numpy(ws.reshape(T, S, sw)[:, :, :P].reshape(T, S * P)).to(cdt)
            acc = torch.zeros((S * P, plan.chunks * V), dtype=cdt)
            for t in range(T - 1, -1, -1):
                acc = acc + rows[t][:, None] * ds[t][None, :]
            for tid in range(plan.threads):
                s, c = divmod(tid, plan.chunks)
                if c >= fcl:
                    continue
                for k in range(P):
                    rl = s * P + k
                    if rl < nrl:
                        dst = (b * R + r0 + rl) * F + (c0 + c) * V
                        assert (dst * elt) % 16 == 0
                        out[dst:dst + V] = acc[rl, c * V:(c + 1) * V]
    return out.view(B, R, F)


def _operands(B, T, R, F, cdt, seed):
    rs = np.random.RandomState(seed)
    s = rs.randn(B, T, R).astype(np.float32) * 2
    w = np.exp(s - s.max(axis=2, keepdims=True))
    w = (w / w.sum(axis=2, keepdims=True)).astype(np.float32)
    x = (rs.randn(B, T, F) * 1e-2).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x).to(cdt)


# chip_smoke.py's edges at the H100's SM count, an item a block; plans at
# other SM counts: a whole image's 49 regions with T R odd (7 regions a
# thread), items of 25 regions with T R odd (4 a thread in f32, 2 in bf16),
# feature blocks of 49 regions, 9 regions in sets of 5; and blocks that take
# several items in turn (resident blocks an SM given), whose buffers hold
# the item before's rows
EMULATED = [(shape, H100_SMS, None) for shape in cs.FOLD_EDGE if shape[0] * shape[1] <= 6400] + [
    ((3, 25, 49, 200), 1, None), ((3, 25, 49, 200), 8, None), ((2, 64, 49, 1024), 1, None),
    ((5, 7, 9, 24), 2, None), ((3, 25, 49, 200), 1, 1), ((5, 7, 9, 24), 2, 1),
    ((64, 25, 49, 200), 8, 1), ((2, 64, 9, 1024), 2, 1), ((2, 64, 9, 1024), 8, 1)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,sms,resident", EMULATED)
def test_emulated_kernel_equals_plain(shape, sms, resident, dtype):
    cdt = DTYPES[dtype]
    w_t, dctx_t = _operands(*shape, cdt, sum(shape) + sms)
    plan = tk.fold_plan(*shape, cdt, sms, resident)
    assert resident is None or plan.grid < plan.items
    got = emulate_fold(w_t, dctx_t, plan)
    assert torch.equal(got, tk.feats_fold_plain(w_t, dctx_t))


def test_edges_cut_as_described():
    """chip_smoke.py's FOLD_EDGE holds the cuts it names: T R odd with w
    rows off 16 bytes, items of 25 and 24 regions at B=64, feature blocks."""
    plans = {shape: tk.fold_plan(*shape, torch.float32) for shape in cs.FOLD_EDGE}
    assert (3 * 25 * 49) % 2 == 1 and (25 * 49 * 4) % 16 != 0
    assert plans[(3, 25, 49, 200)].regions == 2
    assert plans[(64, 25, 49, 200)].regions == 25 and 49 - 25 == 24
    chunks = plans[(2, 64, 9, 1024)].chunks
    assert chunks == 52 and 256 - 4 * chunks == 48
    big = plans[(300, 64, 49, 1024)]
    assert big.regions == 49 and big.chunks < 256
    assert tk.fold_plan(2, 64, 9, 1024, torch.bfloat16).chunks < 128


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_equals_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: train_feats_fold is a CUDA kernel with no CPU mode")
    cdt = DTYPES[dtype]
    for i, shape in enumerate(cs.FOLD_EDGE):
        w_t, dctx_t = (x.cuda() for x in _operands(*shape, cdt, i))
        assert torch.equal(tk.feats_fold(w_t, dctx_t), tk.feats_fold_plain(w_t, dctx_t)), shape
