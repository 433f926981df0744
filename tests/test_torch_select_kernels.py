"""The select kernels (c) ``beam_select`` and (c1) ``greedy_select`` of the
port, as they run on the card, modelled in numpy on the CPU.

The CUDA kernels cannot run here, so a numpy model repeats their merge
step by step: each lane's candidates as the kernels load them (16-byte
vectors and a scalar head and tail: ``row_split``), the order-preserving
32-bit key (-0.0 made +0.0), three rounds of "maximum key, then least
index among the lanes at that key" for a row's top-3 (one round for the
greedy argmax), and the logsumexp in the plain version's form (the row
maximum first, then one exp a chunk and a butterfly sum).  The model is
held against ``top_k_first`` and against the plain selects on the edge
cases that ``chip_smoke.py`` phase 3c sends to the kernels: ties across
chunks and lanes, +-0.0, chunks of -inf, dead beams, a completion won by
the last beam.  Ints must be equal; scores agree within 1e-4 (the
kernels' SMALL_SCORE_TOL: the sums of exp run in another order).  The plain
selects are held against captionax's kernels through whole small decodes
on tie-heavy weights (tokens equal, scores within 3e-3 as in
test_torch_beam.py)."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from captionax.models import decoder as jdec
from captionax.ops import decode_kernel as jdk
from captionax_torch.decode.search import NEG_INF, top_k_first
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
SCORE_TOL = 1e-4      # chip_smoke.SMALL_SCORE_TOL
ORACLE_TOL = 3e-3     # captionax's kernel against the port's decode, as test_torch_beam.py
END = 2
NO_KEY = np.uint32(0)
INT_MAX = np.iinfo(np.int32).max
# (images, chunks C, H, T) of chip_smoke.py's phase 3c, all but the decode's
# 64 images
SHAPES = cs.SELECT_EDGE[:-1]


# ------------------------------------------------------------------ the model
def order_key(x) -> np.ndarray:
    """decode_common.cuh's order_key: uint32 keys in the order of the f32 values."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def key_value(k) -> np.ndarray:
    k = np.asarray(k, dtype=np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def lane_elements(offset: int, n: int) -> list:
    """The elements of a row of n partials that each lane loads: 16-byte
    vector k to lane k % 32, the head's and the tail's scalars to lanes
    0, 1, ...  -> per lane, the element positions."""
    head, body, tail = tdk.row_split(offset, n)
    out = [[] for _ in range(32)]
    for k in range(body):
        out[k % 32] += range(head + 4 * k, head + 4 * k + 4)
    for e in range(head):
        out[e].append(e)
    for e in range(tail):
        out[e].append(head + 4 * body + e)
    return out


def rounds(heads, pops: int):
    """``pops`` rounds of first_max over per-lane lists of (key, index,
    value), each sorted: the first lane at (max key, min index) pops its
    head.  -> [(key, index, value)] in order."""
    lists = [list(x) for x in heads]
    got = []
    for _ in range(pops):
        top = [x[0] if x else (NO_KEY, INT_MAX, -np.inf) for x in lists]
        kmax = max(k for k, _, _ in top)
        imin = min(i for k, i, _ in top if k == kmax)
        lane = next(l for l, (k, i, _) in enumerate(top) if k == kmax and i == imin)
        got.append(top[lane])
        lists[lane].pop(0)
    return got


def lane_top(vals, idx, offset: int, keep: int):
    """Each lane's best ``keep`` candidates of a row, (key desc, index asc)."""
    keys = order_key(vals)
    per = []
    for el in lane_elements(offset, len(vals)):
        c = sorted(((keys[e], int(idx[e]), np.float32(vals[e])) for e in el),
                   key=lambda x: (-int(x[0]), x[1]))
        per.append(c[:keep])
    return per


def model_row_top3(vals, idx, offset: int):
    return rounds(lane_top(vals, idx, offset, 3), 3)


def model_logz(m, s, offset: int) -> np.float32:
    """(c)'s logsumexp of a row's chunk maxima m and sums s: M as the max
    key over the lanes, each lane's sum of s exp(m - M) over its chunks in
    its load order, a butterfly sum over the warp; in f32."""
    per = lane_elements(offset, len(m))
    lane_max = [max((m[e] for e in el), default=-np.inf) for el in per]
    M = key_value(order_key(np.float32(max(lane_max, key=lambda v: order_key(v)))))
    sums = np.zeros(32, np.float32)
    for lane, el in enumerate(per):
        for e in el:  # the kernel's slot order: the vectors, then the head, the tail
            sums[lane] += np.float32(s[e]) * np.exp(np.float32(m[e]) - M, dtype=np.float32)
    for o in (16, 8, 4, 2, 1):
        sums = sums + sums[np.arange(32) ^ o]
    return np.float32(M + np.log(sums[0], dtype=np.float32))


def model_beam_select(pv, pi, pm, ps, h_new, state, t: int, end_id: int) -> dict:
    """One step of (c) in numpy: the new state."""
    st = {k: v.clone().numpy() for k, v in state.items()}
    if not st["run"][t]:
        return st
    pv, pi, pm, ps, h_new = (x.numpy() for x in (pv, pi, pm, ps, h_new))
    rows, C, _ = pv.shape
    old_hist = st["hist_in"].copy()
    any_improvable = False
    for img in range(rows // 3):
        cv, ci = [], []
        for b in range(3):
            r = img * 3 + b
            logz = model_logz(pm[r], ps[r], r * C)
            for _, i, v in model_row_top3(pv[r].reshape(-1), pi[r].reshape(-1), r * 3 * C):
                cv.append(np.float32(st["score"][r] + np.float32(v - logz)))
                ci.append(i)
        cand = [q for _, q, _ in rounds([[(k, q, 0.0)] for q, k in enumerate(order_key(cv))], 3)]
        gv = [cv[q] for q in cand]
        ntok = [ci[q] for q in cand]
        par = [q // 3 for q in cand]
        done = [ntok[j] == end_id and gv[j] > NEG_INF / 2 for j in range(3)]
        cbest, win = np.float32(NEG_INF), 0
        for j in range(3):
            cval = gv[j] if done[j] else np.float32(NEG_INF)
            if cval > cbest:
                cbest, win = cval, j
        best_old = st["best_val"][img]
        improve = cbest > best_old and cbest > NEG_INF / 2
        for j in range(3):
            st["h"][img * 3 + j] = h_new[img * 3 + par[j]]
            hist = old_hist[img * 3 + par[j]].copy()
            hist[t + 1] = ntok[j]
            st["hist_out"][img * 3 + j] = hist
            if improve and j == win:
                st["best_seq"][img] = hist
        if improve:
            st["best_val"][img], st["best_len"][img] = cbest, t + 2
        best_new = cbest if improve else best_old
        if any(done):
            st["found"][img] = 1
        for j in range(3):
            sc = np.float32(NEG_INF) if done[j] else gv[j]
            st["score"][img * 3 + j], st["tok"][img * 3 + j] = sc, ntok[j]
            any_improvable |= sc - best_new > 0
    st["run"][t + 1] = int(any_improvable)
    return st


def model_greedy_select(pv, pi, h_new, state, t: int, end_id: int) -> dict:
    """One step of (c1) in numpy, a warp a row: the new state."""
    st = {k: v.clone().numpy() for k, v in state.items()}
    if not st["run"][t]:
        return st
    pv, pi, h_new = pv.numpy(), pi.numpy(), h_new.numpy()
    rows, C = pv.shape
    live = False
    for r in range(rows):
        nxt = rounds(lane_top(pv[r], pi[r], r * C, 1), 1)[0][1]
        was = bool(st["done"][r])
        st["out"][r, t] = 0 if was else nxt
        if not was:
            st["h"][r] = h_new[r]
            st["tok"][r] = nxt
        now = was or nxt == end_id
        st["done"][r] = int(now)
        live |= not now
    st["run"][t + 1] = int(live)
    return st


def assert_state(got: dict, ref: dict, what: str) -> None:
    for k, r in ref.items():
        g = got[k]
        r = r.numpy() if isinstance(r, torch.Tensor) else r
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=0, atol=SCORE_TOL, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ the key
def test_order_key_orders_like_the_values():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(500) * 10.0 ** rng.randint(-30, 30, 500),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3e38, -3e38],
                        np.round(rng.randn(50), 1)]).astype(np.float32)
    k = order_key(x)
    for a in range(len(x)):
        np.testing.assert_array_equal(k[a] > k, x[a] > x)
        np.testing.assert_array_equal(k[a] == k, x[a] == x)
    assert order_key(-0.0) == order_key(0.0)
    assert NO_KEY < order_key(-np.inf) == 0x007FFFFF < order_key(-3e38)


def test_key_value_inverts_the_key():
    x = np.float32([1.5, -2.25, 0.0, -0.0, np.inf, -np.inf, 1e-40, -7e30])
    back = key_value(order_key(x))
    np.testing.assert_array_equal(back, np.where(x == 0, np.float32(0.0), x))
    assert not np.signbit(back[3])


# ------------------------------------------------------------------ launch shape, alignment
@pytest.mark.parametrize("n_img,sms,want", [(64, 132, 1), (1024, 132, 4), (5, 132, 1),
                                            (1, 132, 1), (525, 132, 4), (524, 132, 2),
                                            (1056, 132, 4), (200, 50, 4), (196, 50, 2),
                                            (60, 50, 1)])
def test_select_images_per_block(n_img, sms, want):
    assert tdk.select_images_per_block(n_img, sms) == want
    blocks = -(-n_img // want)
    assert want in tdk.SELECT_IMAGES and (blocks >= sms or want == 1)


@pytest.mark.parametrize("rows,sms,want", [(1024, 132, 16), (64, 132, 1), (192, 132, 4),
                                           (528, 132, 16), (513, 132, 16), (512, 132, 8),
                                           (264, 132, 8), (132, 132, 4), (66, 132, 2),
                                           (3, 132, 1)])
def test_greedy_select_warps(rows, sms, want):
    """A warp a row: the most warps a block whose grid still has a block
    for every four SMs."""
    assert tdk.greedy_select_warps(rows, sms) == want
    assert want in tdk.GREEDY_SELECT_WARPS and (4 * -(-rows // want) >= sms or want == 1)


@pytest.mark.parametrize("C", [76, 3, 5, 77, 1])
def test_row_split_of_partials(C):
    """Every row of pv/pi (3C words) and pm/ps (C words) splits into a head
    below 4, 16-byte vectors that start on a 16-byte boundary, and a tail
    below 4; at the decode's C = 76 both are all vectors."""
    for n in (3 * C, C):
        for row in range(9):
            head, body, tail = tdk.row_split(row * n, n)
            assert head + 4 * body + tail == n and 0 <= head < 4 and 0 <= tail < 4
            if body:
                assert (row * n + head) % 4 == 0
            if C == 76:
                assert (head, body, tail) == (0, n // 4, 0)
    assert [tdk.row_split(r * 9, 9) for r in range(4)] == [(0, 2, 1), (3, 1, 2), (2, 1, 3),
                                                            (1, 2, 0)]


@pytest.mark.parametrize("hd,vector", [(200, True), (36, True), (37, False), (30, False)])
def test_h_rows_are_vectors_when_h_is_a_multiple_of_4(hd, vector):
    """The kernels copy h as float4 when H % 4 == 0: then every row of h
    (and an image's three rows) starts on a 16-byte boundary."""
    assert (hd % 4 == 0) == vector
    splits = [tdk.row_split(r * hd, hd) for r in range(12)]
    assert all(s == (0, hd // 4, 0) for s in splits) == vector
    assert all(tdk.row_split(i * 3 * hd, 3 * hd)[0] == 0 for i in range(4)) == vector


# ------------------------------------------------------------------ the merge model
@pytest.mark.parametrize("case", cs.SELECT_CASES)
@pytest.mark.parametrize("C", [76, 3, 5, 301])
def test_row_top3_model_vs_top_k_first(case, C):
    g = torch.Generator().manual_seed(C)
    x = cs.edge_logits(12, C, case, g)
    pv, pi, _, _ = cs.edge_partials(x, 3, case == "neginf", g)
    v_ref, sel = top_k_first(pv.reshape(12, -1), 3)
    i_ref = torch.gather(pi.reshape(12, -1), 1, sel)
    for r in range(12):
        got = model_row_top3(pv[r].reshape(-1).numpy(), pi[r].reshape(-1).numpy(), r * 3 * C)
        assert [i for _, i, _ in got] == i_ref[r].tolist()
        assert [float(v) for _, _, v in got] == v_ref[r].tolist()


@pytest.mark.parametrize("case", ["random", "ties", "neginf"])
@pytest.mark.parametrize("C", [76, 3, 77, 301])
def test_logz_model_vs_the_plain_form(case, C):
    g = torch.Generator().manual_seed(100 + C)
    x = cs.edge_logits(6, C, case, g)
    _, _, pm, ps = cs.edge_partials(x, 3, case == "neginf", g)
    M = pm.max(dim=1).values
    ref = M + torch.log(torch.sum(ps * torch.exp(pm - M[:, None]), dim=1))
    full = torch.logsumexp(x, dim=1)
    for r in range(6):
        got = model_logz(pm[r].numpy(), ps[r].numpy(), r * C)
        assert abs(float(got) - float(ref[r])) <= 1e-5 * max(1.0, abs(float(ref[r])))
        if case != "neginf":
            assert abs(float(got) - float(full[r])) <= 1e-4


@pytest.mark.parametrize("case", cs.SELECT_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_beam_model_vs_beam_select_plain(case, shape):
    n_img, C, hd, T = shape
    g = torch.Generator().manual_seed(sum(shape))
    parts, h_new, state, t = cs.edge_beam_inputs(n_img, C, hd, T, case, g, device="cpu")
    got = model_beam_select(*parts, h_new, state, t, END)
    ref = {k: v.clone() for k, v in state.items()}
    tdk.beam_select_plain(*parts, h_new, ref, t, END)
    assert_state(got, ref, f"{case} {shape}")
    if case == "last wins":  # the third candidate completes and improves every image
        assert (ref["best_len"] == t + 2).all() and (ref["best_seq"][:, t + 1] == END).all()
        assert (ref["found"] == 1).all() and (ref["tok"][2::3] == END).all()


@pytest.mark.parametrize("case", cs.SELECT_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_greedy_model_vs_greedy_select_plain(case, shape):
    n_img, C, hd, _ = shape
    g = torch.Generator().manual_seed(7 * sum(shape))
    parts, h_new, state, t = cs.edge_greedy_inputs(n_img * 3, C, hd, 20, case, g, device="cpu")
    got = model_greedy_select(*parts, h_new, state, t, END)
    ref = {k: v.clone() for k, v in state.items()}
    tdk.greedy_select_plain(*parts, h_new, ref, t, END)
    assert_state(got, ref, f"{case} {shape}")


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_closed_gate_leaves_the_state(shape):
    n_img, C, hd, T = shape
    parts, h_new, state, t = cs.edge_beam_inputs(n_img, C, hd, T, "random",
                                                 torch.Generator().manual_seed(3), device="cpu")
    state["run"].zero_()
    before = {k: v.clone() for k, v in state.items()}
    tdk.beam_select_plain(*parts, h_new, state, t, END)
    assert_state(model_beam_select(*parts, h_new, before, t, END), state, "gate")
    for k in before:
        assert torch.equal(before[k], state[k])


def test_dead_beams_at_t0_expand_beam_0():
    """Step 0 from _init_state: beams 1 and 2 at -1e9, so the image's three
    candidates are beam 0's top-3 and every parent is beam 0."""
    g = torch.Generator().manual_seed(11)
    x = cs.edge_logits(3 * 4, 5, "ties", g)
    parts = cs.edge_partials(x, 3, False, g)
    state = tdk._init_state(torch.randn((4, 8), generator=g), 6)
    h_new = torch.randn((12, 8), generator=g)
    got = model_beam_select(*parts, h_new, state, 0, END)
    tdk.beam_select_plain(*parts, h_new, state, 0, END)
    assert_state(got, state, "t=0")
    np.testing.assert_array_equal(state["h"].numpy(), h_new[0::3].repeat_interleave(3, 0).numpy())


# ------------------------------------------------------------------ whole decodes
def _tie_heavy(seed: int, bias: float):
    """A small decoder whose vocab chunk 1 repeats chunk 0 (columns
    128-255 = 0-127, weights and biases), so that every logit of chunk 0 is
    tied with one of chunk 1, </s> (2) with 130 among them."""
    params = jdec.attention_gru_init(jax.random.PRNGKey(seed), 32, 16, 16, 16, 650)
    fc = params["fc"]
    params["fc"] = {"w": fc["w"].at[:, 128:256].set(fc["w"][:, :128]),
                    "b": fc["b"].at[128:256].set(fc["b"][:128]).at[np.array([END, 130])].add(bias)}
    raw = np.random.RandomState(seed + 100).randn(4, 5, 32).astype(np.float32)
    return params, raw


def _carry(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("seed,bias", [(21, 0.4), (23, 1.0)])
def test_beam_decode_on_tie_heavy_weights(seed, bias):
    params, raw = _tie_heavy(seed, bias)
    got = tdk.fused_beam_search(_carry(params), torch.from_numpy(raw), max_steps=15, f32=True,
                                device="cpu")
    ref = jdk.fused_beam_search(params, raw, max_steps=15, block_images=4, interpret=True,
                                f32=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=ORACLE_TOL)


@pytest.mark.parametrize("seed,bias", [(21, 0.4), (23, 1.0)])
def test_greedy_decode_on_tie_heavy_weights(seed, bias):
    params, raw = _tie_heavy(seed, bias)
    got = tdk.fused_greedy(_carry(params), torch.from_numpy(raw), max_len=15, f32=True,
                           device="cpu").numpy()
    ref = jdk.fused_greedy(params, raw, max_len=15, block_rows=8, interpret=True, f32=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # a tied pair's second column (chunk 1) is never the first argmax
    assert not ((got >= 128) & (got < 256)).any()
