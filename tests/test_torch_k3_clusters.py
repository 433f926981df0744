"""The cluster design of K3's recurrence kernels (captionax_torch/ops/
train_kernel.py, csrc/train_recurrence.cu), on the CPU.

- the cluster rule ``cluster_shape``: M = 8 C rows a cluster (a multiple of
  16), and a grid that fills at least 95% of its waves of the clusters the
  card reports wherever some shape can (otherwise the shape with the most
  CTAs at once, in one wave), on the H100's reports for both passes and
  dtypes (PERF.md: f32 pass 1 fits only C = 2);
- the packed weights of ``pack_recurrence``, each CTA's slice decoded lane
  by lane from the mma.sync fragments (bf16) or read from the matrices
  (f32), in both orientations, against U_a, w_ih^T and w_hh^T;
- a numpy-level emulation of pass 1 as the kernels split it (the forward
  products from each CTA's column slices, dx and dh as the CTAs' partial
  sums over their groups added in rank order, every product operand
  rounded to the compute dtype: one bf16 term each) against
  ``bwd_recurrence_plain``: within the f32 gradient tolerances of
  tests/test_torch_train_kernel.py in f32, and within chip_smoke.py's
  BF16_REL_BOUND (5e-2 of the largest entry) in bf16;
- ``feats_fold_plain`` on pass 1's fold operands equals pass 1's d_feats bit
  for bit, f32 and bf16.
"""

import numpy as np
import pytest
import torch

from captionax_torch.ops import decode_kernel as tdk
from captionax_torch.ops import train_kernel as tk

torch.set_num_threads(1)

# clusters the H100 runs at once at full width (R=49, F=E=H=200), by
# (pass, dtype) and CTAs a cluster (chip_smoke.py phase 1, PERF.md)
H100_ACTIVE = {
    "f32 forward": {2: 66, 4: 30, 8: 0},
    "f32 pass 1": {2: 66, 4: 0, 8: 0},
    "bf16": {2: 66, 4: 30, 8: 15},
    "all fit": {2: 66, 4: 33, 8: 16},
}
BF16_REL_BOUND = 5e-2


def _fills(B, shape, active):
    c, m = shape
    return tk.cluster_waves(-(-B // m), active[c])


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("report", sorted(H100_ACTIVE))
@pytest.mark.parametrize("B", [1, 5, 13, 64, 1024, 1025])
def test_cluster_shape_fills_the_card(B, report):
    active = H100_ACTIVE[report]
    c, m = tk.cluster_shape(B, active)
    assert (c, m) in tk.CLUSTER_SHAPES and active[c] > 0
    assert m == tk.ROWS_PER_CTA * c and m % 16 == 0
    runnable = [s for s in tk.CLUSTER_SHAPES if active[s[0]] > 0]
    filling = [s for s in runnable if _fills(B, s, active) >= 0.95]
    if filling:
        assert _fills(B, (c, m), active) >= 0.95
        assert (c, m) == filling[0]  # the first in CLUSTER_SHAPES' order that fills
    else:
        # nothing fills: every shape's grid is one wave, and the rule takes
        # the most CTAs at once (ties: the smaller cluster)
        assert -(-B // m) <= active[c]
        ctas = lambda s: min(-(-B // s[1]), active[s[0]]) * s[0]
        assert all(ctas((c, m)) >= ctas(s) for s in runnable)


def test_cluster_shape_at_the_training_batch():
    """B=1024 on the H100: clusters of 4 or 8 would take two waves (30 and
    15 at once), clusters of 2 fill 64 of 66."""
    assert tk.cluster_shape(1024, H100_ACTIVE["bf16"]) == (2, 16)
    assert tk.cluster_shape(1024, H100_ACTIVE["f32 pass 1"]) == (2, 16)
    assert tk.cluster_shape(1024, H100_ACTIVE["all fit"]) == (4, 32)
    assert tk.cluster_waves(64, 66) == pytest.approx(64 / 66)
    assert tk.cluster_waves(65, 64) == pytest.approx(65 / 128)


def test_cluster_shape_raises_when_none_fits():
    with pytest.raises(RuntimeError, match="no cluster shape"):
        tk.cluster_shape(64, {2: 0, 4: 0, 8: 0})


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("U", [2, 3, 5, 25, 32])
def test_cta_groups_partition_the_units(C, U):
    """CTA c holds groups cU/C .. (c+1)U/C - 1: every group once, in order,
    at most ceil(U / C) a CTA; the kernels' owner formula ((u+1)C - 1) // U
    (train_recurrence.cu, group_owner) finds each group's CTA."""
    spans = [tk.cta_groups(c, C, U) for c in range(C)]
    assert spans[0][0] == 0 and spans[-1][1] == U
    for (a, b), (c2, _) in zip(spans, spans[1:]):
        assert b == c2
    assert max(b - a for a, b in spans) <= -(-U // C)
    for u in range(U):
        owner = ((u + 1) * C - 1) // U
        a, b = spans[owner]
        assert a <= u < b


# ------------------------------------------------------------------ packing
def _unfragment(pk: torch.Tensor) -> np.ndarray:
    """mma.sync B fragments [KT, NT, 32, 4] -> the matrix [KT * 16, NT * 8]:
    lane l (g = l // 4, q = l % 4) holds depths 2q, 2q+1, 2q+8, 2q+9 of
    column g of its k16 x n8 tile."""
    KT, NT = pk.shape[:2]
    p = pk.double().numpy()
    w = np.full((KT * 16, NT * 8), np.nan)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for i, k in enumerate((2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)):
            w[k::16][:KT, g::8][:, :NT] = p[:, :, lane, i]
    return w


def _bf16(rs, *shape, scale=0.1):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _expected_slices(ua, wih_t, whh_t, u0, u1):
    """The slices of CTA holding groups [u0, u1), from the weights themselves:
    wx [In, 24 n], wh [H, 32 n], wxr [32 n, In], whr [32 n, H]."""
    H = whh_t.shape[0]
    wx, wh, wxr, whr = [], [], [], []
    for u in range(u0, u1):
        cols = [slice(s * H + 8 * u, s * H + 8 * u + 8) for s in range(3)]
        wx += [wih_t[:, c] for c in cols]
        wh += [whh_t[:, c] for c in cols] + [ua[:, 8 * u:8 * u + 8]]
        wxr += [wih_t[:, c].T for c in cols] + [np.zeros((8, wih_t.shape[0]))]
        whr += [whh_t[:, c].T for c in cols] + [ua[:, 8 * u:8 * u + 8].T]
    cat = lambda xs, ax: np.concatenate(xs, axis=ax) if xs else None
    return cat(wx, 1), cat(wh, 1), cat(wxr, 0), cat(whr, 0)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("In,hd", [(400, 200), (40, 24)])
def test_packed_slices_unpack(dtype, C, In, hd):
    """Each CTA's slices of the packed weights, forward (wx, wh) and reverse
    (wxr, whr), equal the columns of its groups of w_ih^T, w_hh^T and U_a;
    bf16 decoded lane by lane from the CTA's own fragments (n8 tiles
    3 u0 .., 4 u0 .. forward, k16 tiles 2 u0 .. reverse)."""
    rs = np.random.RandomState(C + hd)
    ua, wih_t, whh_t = _bf16(rs, hd, hd), _bf16(rs, In, 3 * hd), _bf16(rs, hd, 3 * hd)
    if dtype == "f32":
        ua, wih_t, whh_t = ua.float(), wih_t.float(), whh_t.float()
    pk = tk.pack_recurrence(ua, wih_t, whh_t)
    U = hd // tk.GATE_UNITS
    ref = [x.double().numpy() for x in (ua, wih_t, whh_t)]
    if dtype == "bf16":
        assert pk["wx"].shape == (-(-In // 16), 3 * U, 32, 4) and pk["wx"].dtype == torch.bfloat16
        assert pk["whr"].shape == (2 * U, hd // 8, 32, 4)
    else:
        assert pk["wx"].shape == (In, 24 * U) and pk["wxr"].shape == (32 * U, In)
    for c in range(C):
        u0, u1 = tk.cta_groups(c, C, U)
        if u0 == u1:
            continue
        ex, eh, exr, ehr = _expected_slices(*ref, u0, u1)
        if dtype == "bf16":
            got = (_unfragment(pk["wx"][:, 3 * u0:3 * u1])[:In],
                   _unfragment(pk["wh"][:, 4 * u0:4 * u1])[:hd],
                   _unfragment(pk["wxr"][2 * u0:2 * u1]), _unfragment(pk["whr"][2 * u0:2 * u1]))
            pad = _unfragment(pk["wx"])[In:]
            assert not np.isnan(pad).any() and not pad.any()  # depths past In are 0
        else:
            got = (pk["wx"][:, 24 * u0:24 * u1].double().numpy(),
                   pk["wh"][:, 32 * u0:32 * u1].double().numpy(),
                   pk["wxr"][32 * u0:32 * u1].double().numpy(),
                   pk["whr"][32 * u0:32 * u1].double().numpy())
        for g, e in zip(got, (ex, eh, exr, ehr)):
            np.testing.assert_array_equal(g, e)


# ------------------------------------------------------------------ emulation
def _core(b, t, r, f, e, h, cdt, seed):
    rs = np.random.RandomState(seed)
    rn = lambda *s, sc=1.0: torch.from_numpy((rs.randn(*s) * sc).astype(np.float32))
    n_in = e + f
    return (rn(b, r, f).to(cdt), rn(b, r, h).to(cdt), rn(b, h, sc=0.5), rn(b, t, e),
            rn(h, h, sc=h ** -0.5).to(cdt), rn(h, sc=0.1), rn(h, sc=h ** -0.5),
            rn(n_in, 3 * h, sc=n_in ** -0.5).to(cdt), rn(h, 3 * h, sc=h ** -0.5).to(cdt),
            rn(3 * h, sc=0.1), rn(3 * h, sc=0.1))


def _packed(parts, U):
    """[N, H] x 4 slots -> [N, U * 32] in the packed column order (per group
    its slots' 8 units side by side)."""
    N = parts[0].shape[0]
    return torch.stack(parts, dim=1).reshape(N, 4, U, 8).permute(0, 2, 1, 3).reshape(N, U * 32)


def _emulated_pass1(args, hs, g, C):
    """Pass 1 as the kernels split it over a cluster of C CTAs, in f32 with
    every product operand rounded to the compute dtype."""
    feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh = args
    cdt = feats.dtype
    rnd = lambda x: x.to(cdt).float()
    B, R, F = feats.shape
    T, E = embeds.shape[1], embeds.shape[2]
    H = h0.shape[1]
    U = H // 8
    pk = tk.pack_recurrence(ua_w.float(), wih_t.float(), whh_t.float())
    spans = [tk.cta_groups(c, C, U) for c in range(C)]
    unslot = lambda m, n: m.reshape(B, U, n, 8).permute(0, 2, 1, 3).reshape(B, n * H)
    d_att1 = torch.zeros((B, R, H), dtype=cdt)
    d_emb = torch.zeros((B, T, E))
    dh = torch.zeros((B, H))
    d_va = torch.zeros((-(-B // 8) * 8, H))
    w_t, dctx_t = torch.zeros((B, T, R)), torch.zeros((B, T, F), dtype=cdt)
    for t in reversed(range(T)):
        h_prev = h0 if t == 0 else hs[:, t - 1]
        word = torch.zeros((B, E)) if t == 0 else embeds[:, t - 1]
        # [gh | att2] and gi from each CTA's column slices
        ghu = torch.cat([rnd(h_prev) @ pk["wh"][:, 32 * a:32 * b] for a, b in spans], dim=1)
        gh_att2 = unslot(ghu, 4)
        gh, att2 = gh_att2[:, :3 * H] + bhh, gh_att2[:, 3 * H:] + ua_b
        a = torch.tanh(att1 + att2[:, None, :].to(cdt))
        s = torch.sum(a * va.to(cdt), dim=2).float()
        w = torch.softmax(s, dim=1)
        ctx = torch.sum(w.to(cdt)[:, :, None] * feats, dim=1).float()
        x = torch.cat([word, ctx], dim=1)
        gi = unslot(torch.cat([rnd(x) @ pk["wx"][:, 24 * a:24 * b] for a, b in spans], dim=1),
                    3) + bih
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        dh_new = g[:, t] + dh
        dz = dh_new * (h_prev - n)
        dpre_n = dh_new * (1 - z) * (1 - n * n)
        dpre_r = dpre_n * gh[:, 2 * H:] * r * (1 - r)
        dpre_z = dz * z * (1 - z)
        zero = torch.zeros_like(dpre_r)
        adg_i = rnd(_packed([dpre_r, dpre_z, dpre_n, zero], U))
        dx = torch.zeros((B, E + F))
        for a_, b_ in spans:  # the CTAs' partial sums, added in rank order
            dx = dx + adg_i[:, 32 * a_:32 * b_] @ pk["wxr"][32 * a_:32 * b_]
        if t > 0:
            d_emb[:, t - 1] = dx[:, :E]
        dctx3 = dx[:, None, E:].to(cdt)
        w_t[:, t], dctx_t[:, t] = w, dctx3[:, 0]
        dw = torch.sum(dctx3 * feats, dim=2).float()
        ds = w * (dw - torch.sum(w * dw, dim=1, keepdim=True))
        de_lin = ds.to(cdt)[:, :, None] * va.to(cdt) * (1.0 - a * a)
        d_att1 = d_att1 + de_lin
        datt2 = torch.sum(de_lin, dim=1).float()
        d_va[:B] += torch.sum(a.float() * ds[:, :, None], dim=1)
        adg_h = rnd(_packed([dpre_r, dpre_z, dpre_n * r, datt2], U))
        dh = dh_new * z
        for a_, b_ in spans:
            dh = dh + adg_h[:, 32 * a_:32 * b_] @ pk["whr"][32 * a_:32 * b_]
    return (tk.feats_fold_plain(w_t, dctx_t), d_att1, dh, d_emb,
            d_va.view(-1, 8, H).sum(1))


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_pass1_vs_plain(dtype, C):
    """B = 17 (a partial tile at every C), H = 40 (5 groups: some CTAs hold
    none at C = 8), 49 regions."""
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = _core(17, 4, 49, 24, 16, 40, cdt, 3 + C)
    hs = tk.fused_fwd_plain(*args)
    g = torch.from_numpy(np.random.RandomState(9).randn(*hs.shape).astype(np.float32))
    ref = tk.bwd_recurrence_plain(*args, hs, g)
    got = _emulated_pass1(args, hs, g, C)
    for name, a, b in zip(("d_feats", "d_att1", "d_h0", "d_emb", "d_va partials"), got,
                          (ref[0], ref[1], ref[2], ref[3], ref[5])):
        a, b = a.float().numpy(), b.float().numpy()
        scale = max(float(np.abs(b).max()), 1e-3)
        if dtype == "f32":
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=max(2e-5 * scale, 1e-6),
                                       err_msg=name)
        else:
            assert float(np.abs(a - b).max()) <= BF16_REL_BOUND * scale, name


# ------------------------------------------------------------------ the fold
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(13, 6, 49, 40, 24, 32), (5, 1, 9, 24, 24, 24)])
def test_fold_equals_pass1_d_feats(dtype, shape):
    """d_feats folded once per element from (w_t, dctx_t) is pass 1's
    per-step sum, bit for bit (the same roundings in the same order)."""
    cdt = torch.float32 if dtype == "f32" else torch.bfloat16
    args = _core(*shape, cdt, 11)
    hs = tk.fused_fwd_plain(*args)
    g = torch.from_numpy(np.random.RandomState(2).randn(*hs.shape).astype(np.float32))
    out = tk.bwd_recurrence_plain(*args, hs, g, fold_operands=True)
    w_t, dctx_t = out[6]
    assert w_t.dtype == torch.float32 and dctx_t.dtype == cdt
    assert w_t.shape == shape[:3] and dctx_t.shape == (shape[0], shape[1], shape[3])
    folded = tk.feats_fold(w_t, dctx_t)  # the CPU wrapper: the plain version
    assert folded.dtype == cdt
    assert torch.equal(folded, out[0])


def test_fold_wrapper_raises_off_cpu_and_cuda():
    w_t = torch.empty((2, 3, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.feats_fold(w_t, torch.empty((2, 3, 8), dtype=torch.float16, device="meta"))


def test_widths_the_kernels_take():
    """F, E and H in multiples of 8 up to MAX_WIDTH; otherwise the wrappers
    raise before any launch."""
    tk._check_widths(200, 200, 200)
    tk._check_widths(tk.MAX_WIDTH, 8, tk.MAX_WIDTH)
    for bad in ((20, 24, 24), (24, 20, 24), (24, 24, 20), (264, 24, 24), (24, 24, 264)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tk._check_widths(*bad)


def test_pack_matches_the_decode_packing_layout():
    """bf16 packing uses the decode kernels' fragment layout
    (decode_kernel._fragments): the same bytes for the same matrix."""
    rs = np.random.RandomState(0)
    ua, wih_t, whh_t = _bf16(rs, 16, 16), _bf16(rs, 32, 48), _bf16(rs, 16, 48)
    pk = tk.pack_recurrence(ua, wih_t, whh_t)
    f32 = tk.pack_recurrence(ua.float(), wih_t.float(), whh_t.float())
    for k in pk:
        assert torch.equal(pk[k], tdk._fragments(f32[k].to(torch.bfloat16)).contiguous())
