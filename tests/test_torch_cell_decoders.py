"""The port's cell-level captioners against captionax on the CPU: the LSTM
cell, the gated attention, the v0 hypernet, ``cell_decoder_forward`` /
``cell_decoder_infer`` and the Show-Attend-Tell decoder.

The weights are captionax's, carried with ``from_jax_params``; the inputs
are drawn with numpy; the draws are captionax's: the forward's h0 is
``uniform(fold_in(key, 0), (B, H))`` and step t's Gumbel noise is
``gumbel(split(key, T)[t], (B, V))`` (``jax.random.categorical`` is the
argmax of noise + logits), the infer's h0 is ``uniform(key, (B, H))``.
Tolerances: 1e-6 for one cell, one attention and the hypernet (f32, the
same operations); 1e-5 for the decoders' logits over T steps; the ids of
the greedy decodes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import attention as jatt
from captionax.models import cell_decoders as jcd
from captionax.models import hypernet as jhn
from captionax.models import rnn as jrnn
from captionax_torch.interop import from_jax_params
from captionax_torch.models import attention as tatt
from captionax_torch.models import cell_decoders as tcd
from captionax_torch.models import hypernet as thn
from captionax_torch.models import rnn as trnn
from captionax_torch.models.layers import count_params

torch.set_num_threads(1)
B, T, E, H, V = 3, 5, 16, 12, 30
R, NF, A = 7, 20, 10
ONE_TOL = dict(rtol=1e-6, atol=1e-6)
SEQ_TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- pieces
def test_lstm_cell_matches():
    p = jrnn.lstm_cell_init(jax.random.PRNGKey(1), E, H)
    x, h, c = randn(0, B, E), randn(1, B, H), randn(2, B, H)
    jh, jc = jrnn.lstm_cell(p, x, (h, c))
    th, tc = trnn.lstm_cell(carry(p), t(x), (t(h), t(c)))
    close(th, jh, **ONE_TOL)
    close(tc, jc, **ONE_TOL)
    tp = trnn.lstm_cell_init(torch.Generator().manual_seed(0), E, H, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in np_tree(p).items()}
    bound = 1 / np.sqrt(H)
    assert all(float(v.abs().max()) <= bound for v in tp.values())


def test_gated_attention_matches():
    p = jatt.gated_attention_init(jax.random.PRNGKey(2), NF, H, A)
    enc, h = randn(3, B, R, NF), randn(4, B, H)
    jctx, jalpha = jatt.gated_attention(p, enc, h)
    tctx, talpha = tatt.gated_attention(carry(p), t(enc), t(h))
    close(tctx, jctx, **ONE_TOL)
    close(talpha, jalpha, **ONE_TOL)
    tp = tatt.gated_attention_init(torch.Generator().manual_seed(0), NF, H, A, device="cpu")
    assert jax.tree_util.tree_map(np.shape, np_tree(p)) == {
        k: {n: tuple(x.shape) for n, x in v.items()} for k, v in tp.items()}


# ------------------------------------------------------------ v0 hypernet
@pytest.mark.parametrize("w", [1, 100, 127, 128, 129, 1023, 1024, 1031, 120000, 240000])
def test_v0_head_dims_every_bucket(w):
    assert thn._v0_head_dims(w, 128) == jhn._v0_head_dims(w, 128)


@pytest.mark.parametrize("gates,layers", [(3, 1), (4, 1), (3, 2), (4, 2)],
                         ids=["gru", "lstm", "gru-2", "lstm-2"])
def test_hypernet_v0_matches(gates, layers):
    hidden = 16 if gates == 4 else H  # LSTM: w_ih 64 * 16 = 1024, the largest bucket
    jp = jhn.hypernet_v0_init(jax.random.PRNGKey(3), E, E, hidden, gates=gates,
                              num_layers=layers)
    tp = thn.hypernet_v0_init(torch.Generator().manual_seed(3), E, E, hidden, gates=gates,
                              num_layers=layers, device="cpu")
    shapes = lambda tree: [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(tree)]
    assert shapes(jax.tree_util.tree_map(np.asarray, jp)) == shapes(
        jax.tree_util.tree_map(lambda x: x.numpy(), tp))
    assert thn.v0_layer_sizes(E, hidden, gates, layers) == jhn.v0_layer_sizes(
        E, hidden, gates, layers)
    style = randn(5, E)
    jth = jhn.hypernet_v0_apply(jp, style)
    tth = thn.hypernet_v0_apply(carry(jp), t(style))
    assert len(tth) == len(jth) == layers
    for a, b in zip(tth, jth):
        assert a.keys() == b.keys()
        for k in a:
            assert tuple(a[k].shape) == b[k].shape
            close(a[k], b[k], **ONE_TOL)


def v0_count(E_, H_, gates, layers, dims):
    """Parameters of the train_captioning model from the head dims alone
    (no tensor is made): the projection, the cell decoder, the v0 hypernet."""
    h = 8 * E_
    hn = sum(a * b + b for a, b in [(E_, 4 * E_), (4 * E_, h)])
    for layer in thn.v0_layer_sizes(E_, H_, gates, layers):
        for _, w in layer:
            d = dims(w, h)
            hn += sum(a * b + b for a, b in zip(d, d[1:]))
    V_ = 9684
    cell = lambda i: gates * H_ * (i + H_ + 2)
    dec = cell(E_) + (layers - 1) * cell(H_) + H_ * V_ + V_ + V_ * E_
    return 2048 * E_ + E_ + dec + hn


@pytest.mark.parametrize("E_,H_,gates,layers,billions", [
    (200, 200, 3, 1, 3.657), (200, 200, 4, 1, 6.474), (200, 150, 4, 1, 2.863),
    (200, 150, 3, 2, 2.789)])
def test_v0_full_width_sizes(E_, H_, gates, layers, billions):
    """The sizes of the model's full-width configurations, from either
    package's bucketing."""
    n = v0_count(E_, H_, gates, layers, thn._v0_head_dims)
    assert n == v0_count(E_, H_, gates, layers, jhn._v0_head_dims)
    assert round(n / 1e9, 3) == billions


# ---------------------------------------------------------- cell decoders
def cell_model(cell, layers, seed=4):
    return np_tree(jcd.cell_decoder_init(jax.random.PRNGKey(seed), E, H, V, cell=cell,
                                         num_layers=layers))


def thetas_of(cell, layers, per_layer: bool):
    """Generated cell tensors: one theta (layer 0) or one per layer."""
    gates = 3 if cell == "gru" else 4
    hn = jhn.hypernet_v0_init(jax.random.PRNGKey(5), E, E, H, gates=gates, num_layers=layers)
    th = np_tree(jhn.hypernet_v0_apply(hn, randn(6, E)))
    return th if per_layer else th[0]


def carry_cell_params(cp):
    if cp is None:
        return None
    return [carry(x) for x in cp] if isinstance(cp, list) else carry(cp)


def captionax_draws(key, random_h0: bool, sample: bool):
    h0 = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (B, H))) if random_h0 else None
    noise = None
    if sample:
        keys = jax.random.split(key, T)
        noise = np.stack([np.asarray(jax.random.gumbel(keys[i], (B, V), jnp.float32))
                          for i in range(T)])
    return h0, noise


CASES = [(cell, layers, theta, tf, h0)
         for cell in ("gru", "lstm") for layers in (1, 2)
         for theta in ("own", "single", "per-layer") for tf in (True, False)
         for h0 in (False, True)]


@pytest.mark.parametrize("cell,layers,theta,tf,random_h0", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_cell_decoder_forward_matches(cell, layers, theta, tf, random_h0):
    params = cell_model(cell, layers)
    cp = None if theta == "own" else thetas_of(cell, layers, theta == "per-layer")
    feats = randn(7, B, E)
    caps = np.random.RandomState(8).randint(0, V, (B, T)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    ref = jcd.cell_decoder_forward(params, feats, caps, cell=cell, teacher_forcing=tf,
                                   rng=key, random_h0=random_h0, cell_params=cp)
    h0, noise = captionax_draws(key, random_h0, not tf)
    got = tcd.cell_decoder_forward(carry(params), t(feats), t(caps), cell=cell,
                                   teacher_forcing=tf, random_h0=random_h0,
                                   cell_params=carry_cell_params(cp),
                                   h0=None if h0 is None else t(h0),
                                   gumbel=None if noise is None else t(noise))
    assert tuple(got.shape) == (B, T, V)
    close(got, ref, **SEQ_TOL)


def test_cell_decoder_forward_draws_its_own():
    params = carry(cell_model("gru", 1))
    feats = t(randn(7, B, E))
    caps = t(np.random.RandomState(8).randint(0, V, (B, T)).astype(np.int32))
    drawn = [tcd.cell_decoder_forward(params, feats, caps, teacher_forcing=False,
                                      random_h0=True, generator=torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])
    # no draws and no generator: teacher-forced, as captionax without a key
    tf = tcd.cell_decoder_forward(params, feats, caps, teacher_forcing=True)
    assert torch.equal(tcd.cell_decoder_forward(params, feats, caps, teacher_forcing=False), tf)


@pytest.mark.parametrize("cell,layers,random_h0", [("gru", 1, True), ("gru", 2, False),
                                                   ("lstm", 1, False), ("lstm", 2, False)])
def test_cell_decoder_infer_same_ids(cell, layers, random_h0):
    params = cell_model(cell, layers, seed=11)
    cp = thetas_of(cell, layers, per_layer=layers == 2)
    feats = randn(12, 8, E) * 3
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jcd.cell_decoder_infer(params, feats, max_len=9, cell=cell, end_id=2,
                                            cell_params=cp, random_h0=random_h0, rng=key))
    h0 = t(np.asarray(jax.random.uniform(key, (8, H)))) if random_h0 else None
    got = tcd.cell_decoder_infer(carry(params), t(feats), max_len=9, cell=cell, end_id=2,
                                 cell_params=carry_cell_params(cp), h0=h0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------ Show-Attend-Tell
def sat_model(seed=14):
    return np_tree(jcd.show_attend_tell_init(jax.random.PRNGKey(seed), NF, E, H, A, V))


def test_show_attend_tell_forward_matches():
    params = sat_model()
    enc = randn(15, B, R, NF)
    caps = np.random.RandomState(16).randint(0, V, (B, T)).astype(np.int32)
    jl, ja = jcd.show_attend_tell_forward(params, enc, caps)
    tl, ta = tcd.show_attend_tell_forward(carry(params), t(enc), t(caps))
    assert tuple(tl.shape) == (B, T - 1, V) and tuple(ta.shape) == (B, T - 1, R)
    close(tl, jl, **SEQ_TOL)
    close(ta, ja, **SEQ_TOL)
    tp = tcd.show_attend_tell_init(torch.Generator().manual_seed(0), NF, E, H, A, V,
                                   device="cpu")
    assert [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(params)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x.numpy(), tp))]
    assert float(tp["fc"]["w"].abs().max()) <= 0.1 and not tp["fc"]["b"].any()
    assert count_params(tp) == sum(np.size(x) for x in jax.tree_util.tree_leaves(params))


def test_show_attend_tell_sample_same_ids():
    params = sat_model(17)
    enc = randn(18, 8, R, NF) * 2
    ref = np.asarray(jcd.show_attend_tell_sample(params, enc, max_len=9, bos_id=1, end_id=2))
    got = tcd.show_attend_tell_sample(carry(params), t(enc), max_len=9, bos_id=1, end_id=2)
    np.testing.assert_array_equal(got.numpy(), ref)
