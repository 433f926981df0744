"""The port's greedy decode and sampling against captionax's, on the CPU.

The port's ``fused_greedy`` (its wrappers run the plain versions of the K2
kernels for CPU tensors), its plain ``greedy`` and its ``sample`` are held
against captionax's scan ``greedy`` and ``sample`` and its Pallas
``fused_greedy(interpret=True, f32=True)``, at the shapes and seeds of
tests/test_decode_kernel.py, on the same weights (carried with
``from_jax_params``) and the same numpy features.  Tokens must be equal
(f32; tolerance: none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.decode.search import greedy as j_greedy
from captionax.decode.search import sample as j_sample
from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax.ops import decode_kernel as jdk
from captionax.train.steps import synthesize_theta_batched as j_synth_batched
from captionax_torch.decode import search as tsearch
from captionax_torch.decode.search import top_k_first
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
NF, F, E, H, V, B, R = 64, 24, 24, 24, 301, 6, 9
SEEDS = [(5, 0.35), (7, 0.45), (11, 0.3)]
END = 2


def make(seed, eos_bias, nf=NF, f=F, e=E, h=H, v=V, batch=B, regions=R):
    params = jdec.attention_gru_init(jax.random.PRNGKey(seed), nf, f, e, h, v)
    params["fc"]["b"] = params["fc"]["b"].at[2].add(eos_bias)
    raw = np.random.RandomState(seed + 100).randn(batch, regions, nf).astype(np.float32)
    return params, raw


def carry(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def port_fused(params, raw, **kw):
    return tdk.fused_greedy(carry(params), torch.from_numpy(raw), f32=True,
                            device="cpu", **kw).numpy()


def exit_step(tokens, max_len):
    """Steps a decode with the reference's early exit runs: up to the step
    at which the last row emits </s>, or every step if a row never does."""
    ends = [np.flatnonzero(row == END) for row in np.asarray(tokens)]
    if any(len(e) == 0 for e in ends):
        return max_len
    return max(int(e[0]) + 1 for e in ends)


@pytest.mark.parametrize("seed,bias", SEEDS)
class TestSeeds:
    def test_greedy_vs_jax_greedy(self, seed, bias):
        params, raw = make(seed, bias)
        ref = np.asarray(j_greedy(params, raw, max_len=20))
        got = tsearch.greedy(carry(params), torch.from_numpy(raw), max_len=20, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_fused_vs_jax_fused(self, seed, bias):
        params, raw = make(seed, bias)
        ref = jdk.fused_greedy(params, raw, max_len=20, block_rows=8, interpret=True,
                               f32=True)
        np.testing.assert_array_equal(port_fused(params, raw, max_len=20), np.asarray(ref))

    def test_fused_vs_jax_greedy(self, seed, bias):
        params, raw = make(seed, bias)
        ref = np.asarray(j_greedy(params, raw, max_len=20))
        np.testing.assert_array_equal(port_fused(params, raw, max_len=20), ref)


@pytest.mark.parametrize("tie", [False, True])
def test_large_vocab_ties(tie):
    """vp=768: six 128-column chunks; with ``tie`` fc columns 10 and 500
    (chunks 0 and 3) give equal logits and the first occurrence, 10, wins."""
    params, raw = make(23, 0.4, nf=32, f=16, e=16, h=16, v=650, batch=4, regions=5)
    if tie:
        fc = params["fc"]
        params["fc"] = {
            "w": fc["w"].at[:, 500].set(fc["w"][:, 10]),
            "b": fc["b"].at[500].set(fc["b"][10] + 3.0).at[10].add(3.0),
        }
    ref = np.asarray(j_greedy(params, raw, max_len=15))
    got = port_fused(params, raw, max_len=15)
    np.testing.assert_array_equal(got, ref)
    ref_k = jdk.fused_greedy(params, raw, max_len=15, block_rows=8, interpret=True, f32=True)
    np.testing.assert_array_equal(got, np.asarray(ref_k))
    if tie:
        assert (ref == 10).any() and not (ref == 500).any()


def _bank():
    params, raw = make(31, 0.6)
    hn = j_hypernet_init(jax.random.split(jax.random.PRNGKey(31), 3)[0], hyper_emb=E,
                         input_dim=E + F, hidden_dim=H)
    thetas = j_synth_batched({"decoder": params, "hn": hn},
                             params["embed"][jnp.array([4, 3, 6])])
    return params, raw, thetas


@pytest.mark.parametrize("rows", [[0, 1, 2, 2, 1, 0], [0, 1, 2, 2, 1, 7], [-3, 1, 9, 2, 1, 0]])
def test_theta_bank_style_rows(rows):
    """An S=3 bank with one style per image; out-of-range rows clamp to
    [0, S) in the port, in captionax's kernel, and so match the per-row
    theta scan at the clamped rows."""
    params, raw, thetas = _bank()
    rows = np.asarray(rows, np.int32)
    got = port_fused(params, raw, gru_params=carry(thetas), max_len=10,
                     style_rows=torch.from_numpy(rows))
    ref_k = jdk.fused_greedy(params, raw, gru_params=thetas, max_len=10, block_rows=3,
                             interpret=True, f32=True, style_rows=jnp.asarray(rows))
    np.testing.assert_array_equal(got, np.asarray(ref_k))
    theta_img = jax.tree_util.tree_map(lambda x: x[np.clip(rows, 0, 2)], thetas)
    ref = np.asarray(j_greedy(params, raw, max_len=10, gru_params=theta_img))
    np.testing.assert_array_equal(got, ref)
    got_scan = tsearch.greedy(carry(params), torch.from_numpy(raw), max_len=10,
                              gru_params=carry(theta_img), device="cpu")
    np.testing.assert_array_equal(got_scan.numpy(), ref)


def test_theta_bank_requires_style_rows():
    params, raw, thetas = _bank()
    with pytest.raises(ValueError, match="style_rows"):
        port_fused(params, raw, gru_params=carry(thetas), max_len=4)


def test_block_rows_must_be_instantiated():
    """(a) is built for the row tiles of TILE_ROWS only; another raises, on
    the CPU as on the card."""
    params, raw = make(5, 0.35)
    dec = tdk.GreedyDecoder(carry(params), max_len=4, device="cpu")
    feats, att1, h0, styles = dec.prepare(raw, None)
    tok = torch.zeros((h0.shape[0],), dtype=torch.int32)
    with pytest.raises(ValueError, match="block_rows"):
        tdk.cell_step(feats, att1, h0, tok, styles, 0, dec.weights(), zero_word_t0=False,
                      block_rows=5)


def test_bf16_weights_decode():
    """The default bf16 storage runs through the same path and mostly agrees
    with f32 (judged by agreement, as in captionax)."""
    params, raw = make(7, 0.45)
    tp = carry(params)
    got = tdk.fused_greedy(tp, torch.from_numpy(raw), max_len=12, device="cpu")
    ref = tdk.fused_greedy(tp, torch.from_numpy(raw), max_len=12, f32=True, device="cpu")
    assert got.shape == ref.shape and got.dtype == torch.int32
    assert (got[:, 0] == ref[:, 0]).float().mean() >= 0.5


@pytest.mark.parametrize("top_k,temperature", [(0, 0.7), (3, 0.7), (0, 1.0), (3, 1.0)])
def test_sample_vs_jax_sample(monkeypatch, top_k, temperature):
    """``sample`` with the Gumbel noise that ``jax.random.categorical`` drew
    in captionax's ``sample`` (one key per step from ``split(rng, max_len)``)
    gives captionax's tokens exactly."""
    params, raw = make(7, 0.45)
    rng = jax.random.PRNGKey(3)
    max_len = 20
    ref = np.asarray(j_sample(params, raw, rng, max_len=max_len, temperature=temperature,
                              top_k=top_k))
    shape = (B, top_k if top_k else V)
    draws = iter([torch.from_numpy(np.array(jax.random.gumbel(key, shape)))
                  for key in jax.random.split(rng, max_len)])

    def jax_noise(generator, shape_, device):
        x = next(draws)
        assert tuple(shape_) == tuple(x.shape)
        return x

    monkeypatch.setattr(tsearch, "_gumbel", jax_noise)
    got = tsearch.sample(carry(params), torch.from_numpy(raw), None, max_len=max_len,
                         temperature=temperature, top_k=top_k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_is_reproducible_from_its_generator():
    params, raw = make(7, 0.45)
    tp = carry(params)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tsearch.sample(tp, torch.from_numpy(raw), g, max_len=12, top_k=5,
                              device="cpu")

    np.testing.assert_array_equal(run(1).numpy(), run(1).numpy())
    assert not torch.equal(run(1), run(2))


def test_gumbel_noise_moments():
    g = torch.Generator().manual_seed(0)
    x = tsearch._gumbel(g, (200000,), "cpu")
    assert torch.isfinite(x).all()
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6
    assert abs(x.mean().item() - 0.5772) < 0.01
    assert abs(x.var().item() - np.pi ** 2 / 6) < 0.03


@pytest.mark.parametrize("seed,bias", [(5, 1.2), (7, 1.2), (7, 0.7), (11, 0.7)])
def test_early_exit(seed, bias):
    """The plain K2 path stops once every row is done, at the step the
    reference's exit would take, and its tokens equal both captionax's
    fused_greedy (which exits) and its scan greedy (which does not)."""
    params, raw = make(seed, bias)
    ref = np.asarray(j_greedy(params, raw, max_len=20))
    ref_k = np.asarray(jdk.fused_greedy(params, raw, max_len=20, block_rows=8,
                                        interpret=True, f32=True))
    dec = tdk.GreedyDecoder(carry(params), max_len=20, f32=True, device="cpu")
    got = dec(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_k)
    steps = int(dec.last_steps)
    assert steps < 20
    assert steps == exit_step(ref, 20)


def test_no_exit_runs_every_step():
    params, raw = make(5, 0.35)
    dec = tdk.GreedyDecoder(carry(params), max_len=20, f32=True, device="cpu")
    got = dec(torch.from_numpy(raw)).numpy()
    assert exit_step(got, 20) == 20 and int(dec.last_steps) == 20


class TestPieces:
    """The plain versions of the K2 kernels against the pieces of captionax's
    greedy kernel they replace (f32, atol 1e-5 where values are compared)."""

    def _setup(self, bank=False):
        params, raw = make(5, 0.35)
        thetas = _bank()[2] if bank else None
        dec = tdk.GreedyDecoder(carry(params), None if thetas is None else carry(thetas),
                                max_len=5, f32=True, device="cpu")
        rows = torch.tensor([0, 2, 1, 9, 1, 0], dtype=torch.int32) if bank else None
        feats, att1, h0, styles = dec.prepare(torch.from_numpy(raw), rows)
        return params, thetas, dec, feats, att1, h0, styles

    @pytest.mark.parametrize("bank", [False, True])
    @pytest.mark.parametrize("t", [0, 3])
    def test_cell_step_greedy_rows_vs_cell_core(self, bank, t):
        """One row per image, and token 0's embedding (not zeros) at t=0."""
        params, thetas, dec, feats, att1, h0, styles = self._setup(bank)
        w = dec.weights()
        h = torch.from_numpy(np.random.RandomState(1).randn(B, H).astype(np.float32))
        tok = torch.from_numpy(np.random.RandomState(2).randint(0, V, B).astype(np.int32))
        if t == 0:
            tok = torch.zeros_like(tok)
        got = tdk.cell_step(feats, att1, h, tok, styles, t, w, zero_word_t0=False)
        jw = jdk._pack_weights(params, None, jnp.float32)
        word = np.asarray(params["embed"])[tok.numpy()]
        if bank:
            S = thetas["w_ih"].shape[0]
            jw = jdk._pack_weight_bank(jw, thetas, jnp.float32)
            onehot = np.eye(S, dtype=np.float32)[np.clip(styles.numpy(), 0, S - 1)]
            ref = jdk._cell_core_multi(word, h.numpy(), feats.numpy(), att1.numpy(),
                                       jw["ua_w"], jw["ua_b"], jw["va"], jw["wih_t"],
                                       jw["whh_t"], jw["bih"], jw["bhh"], onehot, H, S)
        else:
            ref = jdk._cell_core(word, h.numpy(), feats.numpy(), att1.numpy(), jw["ua_w"],
                                 jw["ua_b"], jw["va"], jw["wih_t"], jw["whh_t"], jw["bih"],
                                 jw["bhh"], H)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        if t == 0:  # the beam's zero word differs from token 0's embedding
            zero = tdk.cell_step(feats, att1, h, tok, styles, 0, w, zero_word_t0=True)
            assert not torch.allclose(zero, got)

    @pytest.mark.parametrize("tie", [False, True])
    def test_partials_merge_to_chunked_top1(self, tie):
        """Per-chunk (max, first argmax) merged as greedy_select merges them
        give captionax's _chunked_logits_top1; with ``tie`` columns 10 and
        500 (chunks 0 and 3) are equal and lead, and 10 wins."""
        params, _ = make(21, 0.4, nf=32, f=16, e=16, h=16, v=650, batch=4, regions=5)
        if tie:
            fc = params["fc"]
            params["fc"] = {"w": fc["w"].at[:, 500].set(fc["w"][:, 10]),
                            "b": fc["b"].at[500].set(50.0).at[10].set(50.0)}
        jw = jdk._pack_weights(params, None, jnp.float32)
        hh = np.random.RandomState(3).randn(12, 16).astype(np.float32)
        ref = np.asarray(jdk._chunked_logits_top1(hh, jw["fc_w"], jw["fc_b"], jw["vp"]))
        pv, pi = tdk.logits_top1_partial(torch.from_numpy(hh),
                                         torch.from_numpy(np.array(jw["fc_w"])),
                                         torch.from_numpy(np.array(jw["fc_b"])))
        assert pv.shape == (12, 6) and pi.dtype == torch.int32
        _, sel = top_k_first(pv, 1)
        got = torch.gather(pi, 1, sel)[:, 0]
        np.testing.assert_array_equal(got.numpy(), ref)
        logits = hh @ np.asarray(jw["fc_w"]) + np.asarray(jw["fc_b"])
        np.testing.assert_allclose(pv.max(dim=1).values.numpy(), logits.max(axis=1),
                                   atol=1e-5)
        if tie:
            assert (got.numpy() == 10).all()

    def test_greedy_select_step(self):
        """One step of (c1) on a crafted state: done rows emit 0 and keep h
        and their token; a row that emits </s> is done from then on; run[t+1]
        stays set while some row is not done."""
        rows, C, Hs = 4, 3, 5
        pv = torch.tensor([[1.0, 3.0, 2.0], [5.0, 5.0, 0.0], [0.0, -1.0, 4.0],
                           [2.0, 2.0, 2.0]])
        pi = torch.tensor([[7, 130, 300], [END, 200, 301], [9, 140, 260],
                           [11, 129, 257]], dtype=torch.int32)
        h_new = torch.arange(rows * Hs, dtype=torch.float32).reshape(rows, Hs)
        state = {
            "h": -torch.ones((rows, Hs)), "tok": torch.tensor([4, 4, 4, 4], dtype=torch.int32),
            "done": torch.tensor([0, 0, 1, 0], dtype=torch.int32),
            "out": torch.full((rows, 3), 9, dtype=torch.int32),
            "run": torch.tensor([1, 1, 0, 0], dtype=torch.int32),
        }
        tdk.greedy_select(pv, pi, h_new, state, 1, END)
        np.testing.assert_array_equal(state["out"][:, 1].numpy(), [130, END, 0, 11])
        np.testing.assert_array_equal(state["tok"].numpy(), [130, END, 4, 11])
        np.testing.assert_array_equal(state["done"].numpy(), [0, 1, 1, 0])
        np.testing.assert_array_equal(state["h"][[0, 1, 3]].numpy(), h_new[[0, 1, 3]].numpy())
        assert (state["h"][2] == -1).all()
        assert state["run"].tolist() == [1, 1, 1, 0]
        np.testing.assert_array_equal(state["out"][:, [0, 2]].numpy(), 9)
        # every row done after the next step: run[t+1] stays 0
        pv2 = torch.zeros((rows, C))
        pi2 = torch.full((rows, C), END, dtype=torch.int32)
        tdk.greedy_select(pv2, pi2, h_new, state, 2, END)
        assert state["run"].tolist() == [1, 1, 1, 0]
        assert state["done"].tolist() == [1, 1, 1, 1]

    def test_gate_skips_the_step(self):
        """With run[t] == 0 the plain versions leave the state untouched."""
        _, _, dec, feats, att1, h0, styles = self._setup()
        w = dec.weights()
        state = tdk._init_greedy_state(h0, 4)
        state["run"][0] = 0
        before = {k: v.clone() for k, v in state.items()}
        live = state["run"][0:]
        h_new = tdk.cell_step(feats, att1, state["h"], state["tok"], styles, 0, w,
                              zero_word_t0=False, live=live)
        pv, pi = tdk.logits_top1_partial(h_new, w["fc_w"], w["fc_b"], live=live)
        tdk.greedy_select(pv, pi, h_new, state, 0, END)
        for k in state:
            assert torch.equal(state[k], before[k]), k

    def test_wrappers_raise_off_cpu_and_cuda(self):
        _, _, dec, feats, att1, h0, styles = self._setup()
        w = {k: v.to("meta") for k, v in dec.weights().items()}
        meta = lambda x: x.to("meta")
        h = meta(h0)
        tok = torch.zeros(h.shape[0], dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tdk.cell_step(meta(feats), meta(att1), h, tok, meta(styles), 0, w,
                          zero_word_t0=False)
        with pytest.raises(ValueError, match="no kernel"):
            tdk.logits_top1_partial(h, w["fc_w"], w["fc_b"])
        state = {k: meta(v) for k, v in tdk._init_greedy_state(h0, 3).items()}
        pv = torch.zeros((h.shape[0], 3), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tdk.greedy_select(pv, pv.to(torch.int32), h, state, 0, END)
