"""The port's LSTM captioners, their global encoder and the CLIs' feature
function against captionax on the CPU.

The weights are captionax's, carried with ``from_jax_params``; the inputs
are drawn with numpy; the dropout keep-mask is captionax's own draw
(``bernoulli(key, 1 - rate, (T, B, H))``).  Tolerances: the teacher-forced
logits and attention within 1e-5 (f32 over T steps, sums in another
order); the greedy ids exactly; ``encoder_lstm_apply`` on the ResNet-50
trunk at 64x64 in f32 within 1e-4 of the largest entry (the trunk's f32
tolerance in ``test_torch_encoder.py``), its running stats likewise (in
bf16 the two trunks differ by their rounding points, and BatchNorm over a
batch of four images with similar features magnifies that past any
useful bound); ``make_feature_fn``'s features exactly (the same f16
rounding in the caches).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.cli import common as jcommon
from captionax.core.config import TrainConfig as JTrainConfig
from captionax.models import decoder as jdec
from captionax.models import encoder as jenc
from captionax_torch.cli import common as tcommon
from captionax_torch.core.config import TrainConfig
from captionax_torch.interop import from_jax_params
from captionax_torch.models import decoder as tdec
from captionax_torch.models import encoder as tenc
from test_torch_conv_kernel import captionax_resnet, randomize_bn

torch.set_num_threads(1)
B, T, E, H, V = 3, 5, 16, 12, 30
R, NF = 7, 20
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


def shapes(tree):
    return [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: np.asarray(x.numpy() if hasattr(x, "numpy") else x),
                               tree))]


def captions(seed, n=B):
    return np.random.RandomState(seed).randint(0, V, (n, T)).astype(np.int32)


# ------------------------------------------------------- attention LSTM
@pytest.fixture(scope="module")
def att_params():
    return np_tree(jdec.attention_lstm_init(jax.random.PRNGKey(1), NF, E, H, V))


def test_attention_lstm_init_shapes(att_params):
    tp = tdec.attention_lstm_init(torch.Generator().manual_seed(0), NF, E, H, V, device="cpu")
    assert shapes(tp) == shapes(att_params)


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no dropout", "dropout 0.3"])
def test_lstm_teacher_forced_matches(att_params, rate):
    feats, caps = randn(2, B, R, NF), captions(3)
    key = jax.random.PRNGKey(4)
    jl, ja = jdec.lstm_teacher_forced(att_params, feats, caps, dropout_rate=rate, rng=key)
    keep = t(jax.random.bernoulli(key, 1.0 - rate, (T, B, H))) if rate else None
    tl, ta = tdec.lstm_teacher_forced(carry(att_params), t(feats), t(caps),
                                      dropout_rate=rate, keep=keep)
    assert tuple(tl.shape) == (B, T, V) and tuple(ta.shape) == (B, T, R)
    close(tl, jl, **SEQ_TOL)
    close(ta, ja, **SEQ_TOL)
    if rate:  # the mask does reach the logits
        plain, _ = tdec.lstm_teacher_forced(carry(att_params), t(feats), t(caps))
        assert not torch.allclose(plain, tl)


def test_lstm_teacher_forced_draws_its_mask():
    params = carry(np_tree(jdec.attention_lstm_init(jax.random.PRNGKey(1), NF, E, H, V)))
    feats, caps = t(randn(2, B, R, NF)), t(captions(3))
    a, b, c = (tdec.lstm_teacher_forced(params, feats, caps, 0.5,
                                        generator=torch.Generator().manual_seed(s))[0]
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_lstm_decode_step_matches(att_params):
    feats, h, c, w = randn(5, B, R, NF), randn(6, B, H), randn(7, B, H), randn(8, B, E)
    (jh, jc), jl, ja = jdec.lstm_decode_step(att_params, w, (h, c), feats)
    (th, tc), tl, ta = tdec.lstm_decode_step(carry(att_params), t(w), (t(h), t(c)), t(feats))
    for got, ref in ((th, jh), (tc, jc), (tl, jl), (ta, ja)):
        close(got, ref, rtol=1e-6, atol=1e-6)


def test_lstm_greedy_same_ids():
    params = np_tree(jdec.attention_lstm_init(jax.random.PRNGKey(9), NF, E, H, V))
    feats = randn(10, 8, R, NF) * 2
    ref = np.asarray(jdec.lstm_greedy(params, feats, max_len=9, end_id=2))
    got = tdec.lstm_greedy(carry(params), t(feats), max_len=9, end_id=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any() or (ref == 2).any() or ref.shape == (8, 9)


# ---------------------------------------------------------- seq2seq LSTM
def test_seq_lstm_forward_matches():
    params = np_tree(jdec.seq_lstm_init(jax.random.PRNGKey(11), E, H, V))
    feat, caps = randn(12, B, E), captions(13)
    ref = jdec.seq_lstm_forward(params, feat, caps)
    got = tdec.seq_lstm_forward(carry(params), t(feat), t(caps))
    assert tuple(got.shape) == (B, T, V)
    close(got, ref, **SEQ_TOL)
    # the last caption token is dropped: it changes nothing
    caps2 = caps.copy()
    caps2[:, -1] = (caps2[:, -1] + 1) % V
    assert torch.equal(tdec.seq_lstm_forward(carry(params), t(feat), t(caps2)), got)
    tp = tdec.seq_lstm_init(torch.Generator().manual_seed(0), E, H, V, device="cpu")
    assert shapes(tp) == shapes(params)


# --------------------------------------------------------- EncoderLstm
@pytest.fixture(scope="module")
def enc_params():
    """captionax's encoder_lstm tree with a ResNet-50 trunk whose folded
    BN scales and biases are drawn from a seed (resnet_init's zero conv3
    scales would make every block the identity)."""
    key = jax.random.PRNGKey(14)
    tree = np_tree(jenc.encoder_lstm_init(key, E, depth=50))
    tree["resnet"] = randomize_bn(captionax_resnet(50), seed=15)
    rs = np.random.RandomState(16)
    tree["embed"]["b"] = rs.randn(E).astype(np.float32) * 0.1
    tree["bn"] = {"gamma": rs.uniform(0.5, 1.5, E).astype(np.float32),
                  "beta": rs.randn(E).astype(np.float32) * 0.1}
    return tree


def rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max())


def test_encoder_lstm_apply_matches(enc_params, monkeypatch):
    """Two train-mode batches (the running stats move by momentum 0.01),
    then eval mode on the stats; the trunk in f32 on both sides."""
    tol, tdt = 1e-4, torch.float32
    monkeypatch.setattr(jenc, "resnet_apply",
                        functools.partial(jenc.resnet_apply, compute_dtype=jnp.float32))
    images = [randn(17 + i, 4, 64, 64, 3) for i in range(3)]
    tp = carry(enc_params)
    jstats, tstats = None, None
    for i, train in enumerate((True, True, False)):
        jout, jstats = jenc.encoder_lstm_apply(enc_params, images[i], train=train,
                                               running_stats=jstats)
        tout, tstats = tenc.encoder_lstm_apply(tp, t(images[i]), train=train,
                                               running_stats=tstats, compute_dtype=tdt)
        assert tuple(tout.shape) == (4, E)
        assert rel(tout, jout) <= tol, (i, rel(tout, jout))
        for a, b in zip(tstats, jstats):
            assert rel(a, b) <= tol, i
    # eval mode leaves the stats as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tstats, tenc.encoder_lstm_apply(tp, t(images[0]), False, tstats, compute_dtype=tdt)[1]))


def test_encoder_lstm_init_shapes():
    jp = jax.eval_shape(lambda k: jenc.encoder_lstm_init(k, E, depth=50), jax.random.PRNGKey(0))
    tp = tenc.encoder_lstm_init(torch.Generator().manual_seed(0), E, depth=50, device="cpu")
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)] == shapes(tp)
    assert float(tp["embed"]["w"].std()) == pytest.approx(0.02, rel=0.05)


# ------------------------------------------------------ make_feature_fn
def fake_encode(calls, lib):
    def encode(images):
        x = np.asarray(images, np.float32)
        calls.append(len(x))
        out = np.sin(x.mean(axis=(1, 2, 3))[:, None, None] + np.arange(R * NF).reshape(
            1, R, NF) * 0.37) * 3.1
        return jnp.asarray(out.astype(np.float32)) if lib == "jax" else torch.from_numpy(
            out.astype(np.float32))
    return encode


def image_batches(n_batches=3, with_indices=True):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 255, (n_batches * B, 8, 8, 3)).astype(np.uint8)
    for i in range(n_batches):
        idx = np.arange(i * B, (i + 1) * B)
        b = {"images": imgs[idx]}
        if with_indices:
            b["indices"] = idx
        yield b


@pytest.mark.parametrize("mode", ["none", "host", "device", "no indices"])
def test_make_feature_fn_matches(mode):
    kw = dict(cache_features=mode in ("host", "no indices"), cache_features_device=mode == "device")
    jcalls, tcalls = [], []
    jfn = jcommon.make_feature_fn(fake_encode(jcalls, "jax"), JTrainConfig(**kw))
    tfn = tcommon.make_feature_fn(fake_encode(tcalls, "torch"), TrainConfig(**kw), "cpu")
    for epoch in range(2):
        for b in image_batches(with_indices=mode != "no indices"):
            got, ref = tfn(b), np.asarray(jfn(b))
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref)
    assert tcalls == jcalls
    assert len(tcalls) == (3 if mode in ("host", "device") else 6)
