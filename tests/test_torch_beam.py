"""The port's k=3 beam decode against captionax's, on the CPU.

The port's ``fused_beam_search`` (its wrappers run the plain versions of
the K1 kernels for CPU tensors) and its plain ``beam_search`` are held
against captionax's scan ``beam_search`` and its Pallas
``fused_beam_search(interpret=True, f32=True)``, at the shapes and seeds of
tests/test_decode_kernel.py.  Tokens, found and lengths must be equal;
scores agree within 3e-3, as in test_decode_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.decode import beam_search as j_beam_search
from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_apply as j_hypernet_apply
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax.ops import decode_kernel as jdk
from captionax.train.steps import synthesize_theta_batched as j_synth_batched
from captionax_torch.decode.search import beam_search, top_k_first
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
SCORE_ATOL = 3e-3
NF, F, E, H, V, B, R = 64, 24, 24, 24, 301, 6, 9


def make(seed, eos_bias, nf=NF, f=F, e=E, h=H, v=V, batch=B, regions=R):
    params = jdec.attention_gru_init(jax.random.PRNGKey(seed), nf, f, e, h, v)
    params["fc"]["b"] = params["fc"]["b"].at[2].add(eos_bias)
    raw = np.random.RandomState(seed + 100).randn(batch, regions, nf).astype(np.float32)
    return params, raw


def carry(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def assert_same(got, ref, atol=SCORE_ATOL):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=atol)


def port_fused(params, raw, **kw):
    return tdk.fused_beam_search(carry(params), torch.from_numpy(raw), f32=True,
                                 device="cpu", **kw)


@pytest.mark.parametrize("seed,bias", [(5, 0.35), (7, 0.45), (11, 0.3)])
class TestSingleTheta:
    def test_fused_vs_jax_fused(self, seed, bias):
        params, raw = make(seed, bias)
        ref = jdk.fused_beam_search(params, raw, max_steps=25, block_images=8,
                                    interpret=True, f32=True)
        assert_same(port_fused(params, raw, max_steps=25), ref)

    def test_fused_vs_jax_scan(self, seed, bias):
        params, raw = make(seed, bias)
        ref = j_beam_search(params, raw, k=3, max_steps=25)
        assert_same(port_fused(params, raw, max_steps=25), ref)

    def test_beam_search_vs_jax_scan(self, seed, bias):
        params, raw = make(seed, bias)
        ref = j_beam_search(params, raw, k=3, max_steps=25)
        got = beam_search(carry(params), torch.from_numpy(raw), k=3, max_steps=25,
                          device="cpu")
        assert_same(got, ref)


@pytest.mark.parametrize("batch,block_images", [(5, 2), (5, 4), (7, 1), (1, 4)])
def test_batch_not_a_multiple_of_the_tile(batch, block_images):
    params, raw = make(7, 0.45, batch=batch)
    ref = jdk.fused_beam_search(params, raw, max_steps=12, block_images=8,
                                interpret=True, f32=True)
    assert_same(port_fused(params, raw, max_steps=12, block_images=block_images), ref)


def test_bf16_weights_decode():
    """The default bf16 storage runs through the same path and mostly agrees
    with f32 (judged by agreement, as in captionax)."""
    params, raw = make(7, 0.45)
    tp = carry(params)
    got = tdk.fused_beam_search(tp, torch.from_numpy(raw), max_steps=12, device="cpu")
    ref = tdk.fused_beam_search(tp, torch.from_numpy(raw), max_steps=12, f32=True,
                                device="cpu")
    assert got.tokens.shape == ref.tokens.shape
    assert (got.found == ref.found).float().mean() >= 0.5


@pytest.mark.parametrize("tie", [False, True])
def test_large_vocab_ties(tie):
    """vp=768: six 128-column chunks, so the per-chunk partials are merged
    across chunks; with ``tie`` two fc columns in different chunks give
    equal logits and index 10 must rank before 500."""
    params, raw = make(21, 0.4, nf=32, f=16, e=16, h=16, v=650, batch=4, regions=5)
    if tie:
        fc = params["fc"]
        params["fc"] = {
            "w": fc["w"].at[:, 500].set(fc["w"][:, 10]),
            "b": fc["b"].at[500].set(fc["b"][10] + 3.0).at[10].add(3.0),
        }
    ref = j_beam_search(params, raw, k=3, max_steps=15)
    got = port_fused(params, raw, max_steps=15)
    assert_same(got, ref)
    ref_k = jdk.fused_beam_search(params, raw, max_steps=15, block_images=4,
                                  interpret=True, f32=True)
    assert_same(got, ref_k)


def test_hypernet_theta():
    params, raw = make(3, 0.4)
    hn = j_hypernet_init(jax.random.PRNGKey(9), hyper_emb=E, input_dim=E + F, hidden_dim=H)
    theta = j_hypernet_apply(hn, jnp.ones((E,)) * 0.1)
    ref = jdk.fused_beam_search(params, raw, gru_params=theta, max_steps=20,
                                block_images=8, interpret=True, f32=True)
    got = port_fused(params, raw, gru_params=carry(theta), max_steps=20)
    assert_same(got, ref)
    ref_scan = j_beam_search(params, raw, k=3, max_steps=20, gru_params=theta)
    got_scan = beam_search(carry(params), torch.from_numpy(raw), k=3, max_steps=20,
                           gru_params=carry(theta), device="cpu")
    assert_same(got_scan, ref_scan)


def _bank():
    params, raw = make(31, 0.6)
    hn = j_hypernet_init(jax.random.PRNGKey(jax.random.split(jax.random.PRNGKey(31), 3)[0][0]),
                         hyper_emb=E, input_dim=E + F, hidden_dim=H)
    thetas = j_synth_batched({"decoder": params, "hn": hn},
                             params["embed"][jnp.array([4, 3, 6])])
    return params, raw, thetas


@pytest.mark.parametrize("rows", [[0, 1, 2, 2, 1, 0], [0, 1, 2, 2, 1, 7], [-3, 1, 9, 2, 1, 0]])
@pytest.mark.parametrize("block_images", [1, 4])
def test_theta_bank_style_rows(rows, block_images):
    """An S=3 bank with one style per image; out-of-range rows clamp to
    [0, S) in both packages."""
    params, raw, thetas = _bank()
    rows = np.asarray(rows, np.int32)
    ref = jdk.fused_beam_search(params, raw, gru_params=thetas, max_steps=10,
                                block_images=2, interpret=True, f32=True,
                                style_rows=jnp.asarray(rows))
    got = port_fused(params, raw, gru_params=carry(thetas), max_steps=10,
                     block_images=block_images, style_rows=torch.from_numpy(rows))
    assert_same(got, ref)


def test_theta_bank_matches_per_image_scan():
    params, raw, thetas = _bank()
    rows = np.array([0, 1, 2, 2, 1, 0], np.int32)
    theta_img = jax.tree_util.tree_map(lambda x: x[rows], thetas)
    ref = j_beam_search(params, raw, k=3, max_steps=8, gru_params=theta_img)
    got = port_fused(params, raw, gru_params=carry(thetas), max_steps=8,
                     style_rows=torch.from_numpy(rows))
    assert_same(got, ref)
    got_scan = beam_search(carry(params), torch.from_numpy(raw), k=3, max_steps=8,
                           gru_params=carry(theta_img), device="cpu")
    assert_same(got_scan, ref)


@pytest.mark.parametrize("seed,bias", [(5, 1.2), (7, 1.2), (11, 0.3), (5, 0.5)])
def test_early_exit(seed, bias):
    """The plain K1 path stops once no beam can improve its image's best
    completion, at the step captionax's kernel stops (its ``debugt`` probe
    reports the exit step, one tile here), and its result equals both that
    kernel's and the scan beam search's, which runs every step."""
    params, raw = make(seed, bias)
    dec = tdk.BeamDecoder(carry(params), max_steps=25, f32=True, device="cpu")
    got = dec(torch.from_numpy(raw))
    steps = int(dec.last_steps)
    assert steps < 25
    assert_same(got, jdk.fused_beam_search(params, raw, max_steps=25, block_images=8,
                                           interpret=True, f32=True))
    assert_same(got, j_beam_search(params, raw, k=3, max_steps=25))
    probe = jdk.fused_beam_search(params, raw, max_steps=25, block_images=8,
                                  interpret=True, f32=True, ablate="debugt")
    assert (np.asarray(probe.lengths) == steps).all()


def test_no_exit_runs_every_step():
    params, raw = make(5, 0.35)
    dec = tdk.BeamDecoder(carry(params), max_steps=25, f32=True, device="cpu")
    dec(torch.from_numpy(raw))
    assert int(dec.last_steps) == 25


def test_theta_bank_requires_style_rows():
    params, raw, thetas = _bank()
    with pytest.raises(ValueError, match="style_rows"):
        port_fused(params, raw, gru_params=carry(thetas), max_steps=4)


class TestPieces:
    """The plain versions of the three K1 kernels against the pieces of
    captionax's kernel they replace (f32, atol 1e-5)."""

    def _setup(self, bank=False):
        params, raw = make(5, 0.35)
        tp = carry(params)
        thetas = None
        if bank:
            _, _, thetas = _bank()
        dec = tdk.BeamDecoder(tp, None if thetas is None else carry(thetas),
                              max_steps=5, f32=True, device="cpu")
        rows = torch.tensor([0, 2, 1, 9, 1, 0], dtype=torch.int32) if bank else None
        feats, att1, h0, styles = dec.prepare(torch.from_numpy(raw), rows)
        return params, thetas, dec, feats, att1, h0, styles

    @pytest.mark.parametrize("bank", [False, True])
    def test_cell_step_vs_cell_core(self, bank):
        params, thetas, dec, feats, att1, h0, styles = self._setup(bank)
        w = dec.weights()
        rows = B * 3
        h = torch.from_numpy(np.random.RandomState(1).randn(rows, H).astype(np.float32))
        tok = torch.from_numpy(np.random.RandomState(2).randint(0, V, rows).astype(np.int32))
        got = tdk.cell_step(feats, att1, h, tok, styles, 3, w)
        jw = jdk._pack_weights(params, None, jnp.float32)
        img = np.arange(rows) // 3
        word = np.asarray(params["embed"])[tok.numpy()]
        f_r, a_r = feats.numpy()[img], att1.numpy()[img]
        if bank:
            S = thetas["w_ih"].shape[0]
            jw = jdk._pack_weight_bank(jw, thetas, jnp.float32)
            srow = np.clip(styles.numpy(), 0, S - 1)[img]
            onehot = np.eye(S, dtype=np.float32)[srow]
            ref = jdk._cell_core_multi(word, h.numpy(), f_r, a_r, jw["ua_w"], jw["ua_b"],
                                       jw["va"], jw["wih_t"], jw["whh_t"], jw["bih"],
                                       jw["bhh"], onehot, H, S)
        else:
            ref = jdk._cell_core(word, h.numpy(), f_r, a_r, jw["ua_w"], jw["ua_b"], jw["va"],
                                 jw["wih_t"], jw["whh_t"], jw["bih"], jw["bhh"], H)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        zero = tdk.cell_step(feats, att1, h, tok, styles, 0, w)
        tok0 = torch.zeros_like(tok)
        np.testing.assert_array_equal(
            zero.numpy(), tdk.cell_step(feats, att1, h, tok0, styles, 0, w).numpy())

    @pytest.mark.parametrize("tie", [False, True])
    def test_partials_merge_to_chunked_top3(self, tie):
        """Per-chunk partials merged as beam_select merges them give the
        top-3 and logsumexp of captionax's _chunked_logits_top3; with
        ``tie`` columns 10 and 500 (chunks 0 and 3) are equal and lead."""
        params, raw = make(21, 0.4, nf=32, f=16, e=16, h=16, v=650, batch=4, regions=5)
        if tie:
            fc = params["fc"]
            params["fc"] = {"w": fc["w"].at[:, 500].set(fc["w"][:, 10]),
                            "b": fc["b"].at[500].set(50.0).at[10].set(50.0)}
        jw = jdk._pack_weights(params, None, jnp.float32)
        hh = np.random.RandomState(3).randn(12, 16).astype(np.float32)
        v3, i3, logz = jdk._chunked_logits_top3(hh, jw["fc_w"], jw["fc_b"], jw["vp"])
        pv, pi, pm, ps = tdk.logits_top3_partial(
            torch.from_numpy(hh), torch.from_numpy(np.array(jw["fc_w"])),
            torch.from_numpy(np.array(jw["fc_b"])))
        assert pv.shape == (12, 6, 3)
        mv, sel = top_k_first(pv.reshape(12, -1), 3)
        mi = torch.gather(pi.reshape(12, -1), 1, sel)
        M = pm.max(dim=1).values
        mz = M + torch.log((ps * torch.exp(pm - M[:, None])).sum(dim=1))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(i3))
        np.testing.assert_allclose(mv.numpy(), np.asarray(v3), atol=1e-5)
        np.testing.assert_allclose(mz.numpy(), np.asarray(logz), atol=1e-5)
        if tie:
            assert (mi[:, :2].numpy() == [10, 500]).all()

    def test_wrappers_raise_off_cpu_and_cuda(self):
        _, _, dec, feats, att1, h0, styles = self._setup()
        w = {k: v.to("meta") for k, v in dec.weights().items()}
        meta = lambda x: x.to("meta")
        h = meta(h0.repeat_interleave(3, 0))
        tok = torch.zeros(h.shape[0], dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tdk.cell_step(meta(feats), meta(att1), h, tok, meta(styles), 0, w)
        with pytest.raises(ValueError, match="no kernel"):
            tdk.logits_top3_partial(h, w["fc_w"], w["fc_b"])


def test_top_k_first_ties_like_lax_top_k():
    x = np.random.RandomState(0).randn(8, 300).astype(np.float32)
    x[:, [7, 90, 250]] = 50.0
    x[2] = 0.0
    ref_v, ref_i = jax.lax.top_k(x, 3)
    v, i = top_k_first(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
