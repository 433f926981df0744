"""The bf16 cell step (a) of K1 and K2, on the CPU.

With bf16 weights ``cell_step`` runs two kernels on the card
(``captionax_torch/ops/csrc/beam_decode.cu``, namespace ``cell``): an
attention phase per image, and a gate phase on the tensor cores whose
operands are [x | h] split into three bf16 terms and the theta packed once
per decoder in mma.sync fragments, gate-interleaved
(``pack_gate_theta``, ``pack_ua``); a row tile takes the bank's product
once for each style present in it, with the other styles' rows zero.  The
kernels themselves run only on the card (``chip_smoke.py``); these tests
hold what surrounds them:
- the packed layouts, decoded here lane by lane from their documented
  fragment layout, give back ``wih_t``, ``whh_t`` and ``ua_w``;
- the gate phase's grid rule ``gate_tile`` at the decode's row counts;
- in a numpy emulation, the three-term products equal the f32 product, the
  per-tile bank product equals the per-row product, and the gate phase
  computed from the packed operands as the kernel takes them gives the
  plain version's ``h_new``;
- ``cell_step_plain`` against captionax's ``_cell_core`` and
  ``_cell_core_multi`` on the same style layouts and at t = 0, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax.ops import decode_kernel as jdk
from captionax.train.steps import synthesize_theta_batched as j_synth_batched
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
NF, F, E, H, V, R = 64, 24, 24, 24, 301, 9
SMS = 132  # the H100's SMs
# one style per image: S = 3, and each layout's image count is 12
LAYOUTS = {
    "clustered": [0] * 4 + [1] * 4 + [2] * 4,
    "interleaved": [0, 1, 2] * 4,
    "one_style": [1] * 12,
    "out_of_range": [-3, 1, 9, 2, 0, 7, 2, 1, -1, 3, 0, 1],
}


def split3(x: np.ndarray):
    """The kernels' split of f32 x into three bf16 terms (as float64)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    hi = t.to(torch.bfloat16)
    r = t - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return [u.double().numpy() for u in (hi, mid, lo)]


def unfragment(pk: np.ndarray) -> np.ndarray:
    """mma.sync B fragments [..., KT, NT, 32, 4] -> [..., KT * 16, NT * 8]:
    lane l (g = l // 4, q = l % 4) holds depths 2q, 2q+1, 2q+8, 2q+9 of its
    k16 tile at column g of its n8 tile."""
    *lead, kt, nt, _, _ = pk.shape
    out = np.zeros((*lead, kt, 16, nt, 8), pk.dtype)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for e, k in enumerate((2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)):
            out[..., :, k, :, g] = pk[..., :, :, lane, e]
    return out.reshape(*lead, kt * 16, nt * 8)


def unpack_gate_theta(pk: torch.Tensor, In: int, hd: int):
    """[S, U, KT, 3, 32, 4] -> (wih_t [S, In, 3H], whh_t [S, H, 3H], the
    padding) as float64: x's k16 tiles first, then h's; per gate, unit
    group u holds columns gate * H + 8u .. + 7."""
    S, U, KT = pk.shape[:3]
    w = unfragment(pk.double().numpy().transpose(0, 3, 2, 1, 4, 5))  # [S, 3, KT*16, U*8]
    ktx = -(-In // 16)
    x, h = w[:, :, :ktx * 16], w[:, :, ktx * 16:]
    cat = lambda a, k: np.concatenate([a[:, q, :k, :hd] for q in range(3)], axis=2)
    pad = np.concatenate([x[:, :, In:].ravel(), h[:, :, hd:].ravel(),
                          w[:, :, :, hd:].ravel()])
    return cat(x, In), cat(h, hd), pad


def bf16(rs: np.random.RandomState, *shape, scale=0.1) -> torch.Tensor:
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("In,hd", [(400, 200), (45, 20)])
def test_packed_theta_unpacks(S, In, hd):
    """H = 200 (25 groups of 8) and H = 20, In = 45 (neither a multiple of
    a tile: padded with zeros)."""
    rs = np.random.RandomState(S + hd)
    wih_t, whh_t = bf16(rs, S, In, 3 * hd), bf16(rs, S, hd, 3 * hd)
    pk = tdk.pack_gate_theta(wih_t, whh_t)
    U = -(-hd // tdk.GATE_UNITS)
    assert pk.shape == (S, U, -(-In // 16) + -(-hd // 16), 3, 32, 4)
    assert pk.dtype == torch.bfloat16 and pk.is_contiguous()
    x, h, pad = unpack_gate_theta(pk, In, hd)
    np.testing.assert_array_equal(x, wih_t.double().numpy())
    np.testing.assert_array_equal(h, whh_t.double().numpy())
    assert not pad.any()


@pytest.mark.parametrize("hd", [200, 20])
def test_packed_ua_unpacks(hd):
    ua = bf16(np.random.RandomState(hd), hd, hd)
    pk = tdk.pack_ua(ua)
    U = -(-hd // tdk.GATE_UNITS)
    assert pk.shape == (U, -(-hd // 16), 32, 4) and pk.is_contiguous()
    w = unfragment(pk.double().numpy().transpose(1, 0, 2, 3))  # [KT*16, U*8]
    np.testing.assert_array_equal(w[:hd, :hd], ua.double().numpy())
    assert not w[hd:].any() and not w[:, hd:].any()


def test_decoder_packs_bf16_weights_only():
    """The decoders' bf16 weights carry the packed copies beside the keys
    the plain version reads; f32 weights do not."""
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jdec.attention_gru_init(jax.random.PRNGKey(0), NF, F, E, H, V)), device="cpu")
    w16 = tdk.BeamDecoder(params, device="cpu").weights()
    np.testing.assert_array_equal(unpack_gate_theta(w16["gates_pk"], E + F, H)[0],
                                  w16["wih_t"].double().numpy())
    assert torch.equal(w16["ua_pk"], tdk.pack_ua(w16["ua_w"]))
    w32 = tdk.BeamDecoder(params, f32=True, device="cpu").weights()
    assert "gates_pk" not in w32 and "ua_pk" not in w32


def test_beam_decoder_tile_by_weight_dtype():
    """The beam decoder's default rows per block of (a): two images with
    bf16 weights, four with f32 (each the faster on the H100); an explicit
    value is kept, one that is not built raises."""
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jdec.attention_gru_init(jax.random.PRNGKey(0), NF, F, E, H, V)), device="cpu")
    assert tdk.BeamDecoder(params, device="cpu").block_images == 2
    assert tdk.BeamDecoder(params, f32=True, device="cpu").block_images == 4
    assert tdk.BeamDecoder(params, block_images=1, device="cpu").block_images == 1
    with pytest.raises(ValueError, match="block_images"):
        tdk.BeamDecoder(params, block_images=3, device="cpu")


# ------------------------------------------------------------------ the grid rule
@pytest.mark.parametrize("rows", [64, 192, 1024, 3072])
def test_gate_tile_fills_the_card(rows):
    """At least 95% of one wave of blocks where some tile allows it (192
    rows and more; at 192 rows a full wave); at 64 rows the finest tile,
    every block in one wave."""
    tile = tdk.gate_tile(rows, 200, SMS)
    assert tile in tdk.GATE_TILES
    blocks = tdk.gate_blocks(rows, 200, tile)
    if rows >= 192:
        assert blocks * 20 >= SMS * 19
    else:
        assert tile == tdk.GATE_TILES[-1] and blocks <= SMS
    # no larger tile of the list would fill the card
    for larger in tdk.GATE_TILES[:tdk.GATE_TILES.index(tile)]:
        assert tdk.gate_blocks(rows, 200, larger) * 20 < SMS * 19
    mb, gb = tile
    assert mb % 16 == 0 and gb in (1, 2, 4, 8, 16)


def test_gate_tile_at_the_decode_shapes():
    """The tiles of the decode's four shapes on the H100: the service's
    192 rows take at least 132 blocks."""
    got = {rows: tdk.gate_tile(rows, 200, SMS) for rows in (64, 192, 1024, 3072)}
    assert got == {64: (16, 1), 192: (16, 2), 1024: (32, 8), 3072: (48, 16)}
    assert tdk.gate_blocks(192, 200, got[192]) >= SMS


def test_gate_blocks_counts_the_grid():
    assert tdk.gate_blocks(192, 200, (16, 2)) == 12 * 13
    assert tdk.gate_blocks(3072, 200, (48, 16)) == 64 * 2
    assert tdk.gate_blocks(1, 20, (16, 1)) == 3


# ------------------------------------------------------------------ emulation
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_term_gate_product_is_the_f32_product(seed):
    """[x | h] (f32, a context's and a GRU state's ranges) times bf16
    weights: the three terms' products summed in f32, one k16 tile and one
    term after another as the accumulators take them, equal the f32 product
    within 1e-6 of its largest entry; the product of bf16 operands (another
    function) is off by more than 1e-4."""
    rs = np.random.RandomState(seed)
    a = np.concatenate([rs.randn(64, 400) * 0.3, np.tanh(rs.randn(64, 200))], 1).astype(np.float32)
    w = bf16(rs, 600, 96, scale=1 / np.sqrt(600)).double().numpy()
    ref = a.astype(np.float64) @ w
    terms = split3(a)
    acc = np.zeros((64, 96), np.float32)
    for k0 in range(0, 600, 16):
        for t in terms:
            acc = (acc + (t[:, k0:k0 + 16] @ w[k0:k0 + 16]).astype(np.float32)).astype(np.float32)
    scale = np.abs(ref).max()
    assert np.abs(acc - ref).max() <= 1e-6 * scale
    assert np.abs(terms[0] @ w - ref).max() > 1e-4 * scale


def gate_phase(x, h, srow, pk, bih, bhh, mb):
    """The gate phase as the kernel computes it, in float64: per tile of
    ``mb`` rows and per style present in it (ascending), the products of
    the three terms of [x | h], with the rows of other styles zero, with
    the weights decoded from the packed layout; then the GRU."""
    rows, hd = h.shape
    In = x.shape[1]
    wx, wh, _ = unpack_gate_theta(pk, In, hd)
    tx, th = split3(x), split3(h)
    gi, gh = np.zeros((rows, 3 * hd)), np.zeros((rows, 3 * hd))
    for r0 in range(0, rows, mb):
        sl = slice(r0, r0 + mb)
        for s in sorted(set(srow[sl].tolist())):
            keep = (srow[sl] == s)[:, None]
            for t in range(3):
                gi[sl] += np.where(keep, tx[t][sl], 0.0) @ wx[s]
                gh[sl] += np.where(keep, th[t][sl], 0.0) @ wh[s]
    return gru(gi, gh, h, bih[srow], bhh[srow])


def gru(gi, gh, h, bi, bh):
    hd = h.shape[1]
    sig = lambda v: 1 / (1 + np.exp(-v))
    r = sig(gi[:, :hd] + gh[:, :hd] + bi[:, :hd] + bh[:, :hd])
    z = sig(gi[:, hd:2 * hd] + gh[:, hd:2 * hd] + bi[:, hd:2 * hd] + bh[:, hd:2 * hd])
    n = np.tanh(gi[:, 2 * hd:] + bi[:, 2 * hd:] + r * (gh[:, 2 * hd:] + bh[:, 2 * hd:]))
    return (1 - z) * n + z * h


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bank_per_tile_equals_per_row(layout):
    """36 beam rows in 16-row tiles, so that tiles cut images: the masked
    product, once per style present in a tile, equals each row times its
    own (clamped) style's theta."""
    rs = np.random.RandomState(5)
    S, In, hd = 3, 45, 20
    styles = np.asarray(LAYOUTS[layout])
    srow = np.clip(styles, 0, S - 1).repeat(3)
    x = rs.randn(36, In).astype(np.float32)
    h = np.tanh(rs.randn(36, hd)).astype(np.float32)
    pk = tdk.pack_gate_theta(bf16(rs, S, In, 3 * hd), bf16(rs, S, hd, 3 * hd))
    bih, bhh = rs.randn(S, 3 * hd) * 0.1, rs.randn(S, 3 * hd) * 0.1
    wx, wh, _ = unpack_gate_theta(pk, In, hd)
    gi = np.stack([x[r].astype(np.float64) @ wx[srow[r]] for r in range(36)])
    gh = np.stack([h[r].astype(np.float64) @ wh[srow[r]] for r in range(36)])
    ref = gru(gi, gh, h.astype(np.float64), bih[srow], bhh[srow])
    for mb in (16, 32, 48):
        np.testing.assert_allclose(gate_phase(x, h, srow, pk, bih, bhh, mb), ref, atol=1e-12)


def make(seed, batch, rpi):
    params = jdec.attention_gru_init(jax.random.PRNGKey(seed), NF, F, E, H, V)
    raw = np.random.RandomState(seed + 100).randn(batch, R, NF).astype(np.float32)
    hn = j_hypernet_init(jax.random.PRNGKey(seed + 1), hyper_emb=E, input_dim=E + F, hidden_dim=H)
    thetas = j_synth_batched({"decoder": params, "hn": hn},
                             params["embed"][jnp.array([4, 3, 6])])
    rows = batch * rpi
    h = np.random.RandomState(1).randn(rows, H).astype(np.float32)
    tok = np.random.RandomState(2).randint(0, V, rows).astype(np.int32)
    return params, raw, thetas, torch.from_numpy(h), torch.from_numpy(tok)


def carry(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def port_inputs(params, thetas, raw, styles, f32):
    dec = tdk.BeamDecoder(carry(params), carry(thetas), max_steps=4, f32=f32, device="cpu")
    feats, att1, _, st = dec.prepare(torch.from_numpy(raw), torch.from_numpy(styles))
    return dec.weights(), feats, att1, st


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("rpi,t", [(3, 0), (3, 2), (1, 0), (1, 2)])
def test_plain_vs_cell_core_multi(layout, rpi, t):
    """``cell_step_plain`` on an S=3 bank against captionax's
    ``_cell_core_multi`` (f32, 1e-5), beam rows (the zero word at t = 0) and
    greedy rows (token 0's embedding at t = 0)."""
    styles = np.asarray(LAYOUTS[layout], np.int32)
    params, raw, thetas, h, tok = make(7, len(styles), rpi)
    w, feats, att1, st = port_inputs(params, thetas, raw, styles, True)
    zero = rpi == 3
    if t == 0:
        tok = torch.zeros_like(tok)
    got = tdk.cell_step_plain(feats, att1, h, tok, st, t, w, zero_word_t0=zero)
    jw = jdk._pack_weight_bank(jdk._pack_weights(params, None, jnp.float32), thetas, jnp.float32)
    img = np.arange(h.shape[0]) // rpi
    word = np.asarray(params["embed"])[tok.numpy()]
    if t == 0 and zero:
        word = np.zeros_like(word)
    onehot = np.eye(3, dtype=np.float32)[np.clip(styles, 0, 2)[img]]
    ref = jdk._cell_core_multi(word, h.numpy(), feats.numpy()[img], att1.numpy()[img],
                               jw["ua_w"], jw["ua_b"], jw["va"], jw["wih_t"], jw["whh_t"],
                               jw["bih"], jw["bhh"], onehot, H, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("t", [0, 2])
def test_plain_vs_cell_core_one_theta(t):
    params, raw, _, h, tok = make(11, 4, 3)
    dec = tdk.BeamDecoder(carry(params), max_steps=4, f32=True, device="cpu")
    feats, att1, _, st = dec.prepare(torch.from_numpy(raw))
    got = tdk.cell_step_plain(feats, att1, h, tok, st, t, dec.weights())
    jw = jdk._pack_weights(params, None, jnp.float32)
    img = np.arange(12) // 3
    word = np.asarray(params["embed"])[tok.numpy()] * (t > 0)
    ref = jdk._cell_core(word, h.numpy(), feats.numpy()[img], att1.numpy()[img], jw["ua_w"],
                         jw["ua_b"], jw["va"], jw["wih_t"], jw["whh_t"], jw["bih"], jw["bhh"], H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def attention_x(feats, att1, h, tok, t, w, rpi, zero_word_t0):
    """x = [word, ctx] as the attention phase computes it (float64)."""
    img = np.arange(h.shape[0]) // rpi
    f64 = lambda v: v.double().numpy()
    word = f64(w["emb"])[tok.numpy()] * (0.0 if t == 0 and zero_word_t0 else 1.0)
    att2 = f64(h) @ f64(w["ua_w"]) + f64(w["ua_b"])
    s = np.tanh(f64(att1)[img] + att2[:, None]) @ f64(w["va"])
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    return np.concatenate([word, np.einsum("rk,rkf->rf", p, f64(feats)[img])], 1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("rpi", [3, 1])
def test_emulated_bf16_cell_vs_plain(layout, rpi):
    """The bf16 cell as the kernels compute it (the attention phase's x,
    then the gate phase from the packed theta, three terms, the bank per
    tile at the tile the grid rule picks at 192 rows) against
    ``cell_step_plain`` with the same bf16 weights, within 1e-5."""
    styles = np.asarray(LAYOUTS[layout], np.int32)
    params, raw, thetas, h, tok = make(7, len(styles), rpi)
    w, feats, att1, st = port_inputs(params, thetas, raw, styles, False)
    ref = tdk.cell_step_plain(feats, att1, h, tok, st, 2, w, zero_word_t0=rpi == 3)
    x = attention_x(feats, att1, h, tok, 2, w, rpi, rpi == 3).astype(np.float32)
    srow = np.clip(styles, 0, 2).repeat(rpi)
    mb, _ = tdk.gate_tile(192, 200, SMS)
    got = gate_phase(x, h.numpy(), srow, w["gates_pk"], w["bih"].double().numpy(),
                     w["bhh"].double().numpy(), mb)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)
