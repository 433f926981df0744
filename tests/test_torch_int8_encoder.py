"""The port's int8 encoder (captionax_torch/models/encoder.py) against
captionax's on the same ResNet-50 (captionax's ``resnet_init`` with every
folded BN scale and bias drawn from a seed, carried by ``from_jax_params``)
and the same 64x64 input.

- ``resnet_quantize``: ``q`` exactly equal, ``wscale``, ``bias`` and
  ``ascale`` within 1e-6 relative, at every conv;
- ``resnet_calibrate`` (f32 forward) within 1e-5 relative;
- a ``_qconv``'s int32 sums exactly equal on the same int8 input, and the
  port's plain int8 product exact against integer arithmetic;
- ``resnet_apply_int8`` / ``encoder_cnn_int8`` in f32, static and dynamic
  scales, within INT8_TRUNK_TOL = 1e-6 of the largest feature of
  captionax's run op by op (measured: 4.2e-7 static, 0 dynamic: both run
  the same f32 operations; the static route's dequantization differs in
  the last bit here and there), and within captionax's own bounds against
  the f32 encoder (tests/test_encoder.py: mean |d| / mean |f| < 0.1,
  cosine > 0.99; measured 0.0132 and 0.99989).

captionax's int8 forward is slow to compile on the CPU, so one
module-scoped run serves every check, as tests/test_encoder.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import encoder as jenc
from captionax_torch.interop import from_jax_params
from captionax_torch.models import encoder as tenc
from test_torch_conv_kernel import captionax_resnet, randomize_bn

torch.set_num_threads(1)
PARAM_RTOL = 1e-6
CALIB_RTOL = 1e-5
INT8_TRUNK_TOL = 1e-6   # of the largest feature
F32_MEAN_REL = 0.1      # captionax's bounds for int8 against f32
F32_COSINE = 0.99


def _convs(qtree):
    for s, blocks in enumerate(qtree["stages"]):
        for b, block in enumerate(blocks):
            for name, qp in block.items():
                yield (s, b, name), qp


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def run():
    params = randomize_bn(captionax_resnet(50), seed=11)
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_jax_params(params, device="cpu")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jscales = jenc.resnet_calibrate(jp, jx, compute_dtype=jnp.float32)
    tscales = tenc.resnet_calibrate(tp, tx, torch.float32)
    jq, tq = jenc.resnet_quantize(jp, act_scales=jscales), tenc.resnet_quantize(tp, tscales)
    jdyn, tdyn = jenc.resnet_quantize(jp), tenc.resnet_quantize(tp)
    return {
        "tp": tp, "x": tx, "jscales": jscales, "tscales": tscales, "jq": jq, "tq": tq,
        "tdyn": tdyn,
        # captionax op by op, as its own tests/test_encoder.py runs it
        "j_static": np.asarray(jenc.resnet_apply_int8(jq, jx, compute_dtype=jnp.float32)),
        "j_dynamic": np.asarray(jenc.resnet_apply_int8(jdyn, jx, compute_dtype=jnp.float32)),
        "t_static": tenc.resnet_apply_int8(tq, tx, torch.float32).numpy(),
        "t_dynamic": tenc.resnet_apply_int8(tdyn, tx, torch.float32).numpy(),
        "f32": tenc.resnet_apply(tp, tx, torch.float32).numpy(),
    }


@pytest.mark.parametrize("stage", range(4))
def test_quantize_matches_captionax(run, stage):
    jconvs = dict(_convs(run["jq"]))
    n = 0
    for key, qp in _convs(run["tq"]):
        if key[0] != stage:
            continue
        ref = jconvs[key]
        assert qp["q"].dtype == torch.int8
        np.testing.assert_array_equal(qp["q"].numpy(), np.asarray(ref["q"]), err_msg=str(key))
        for name in ("wscale", "bias", "ascale"):
            assert qp[name].dtype == torch.float32
            assert _rel(qp[name].numpy(), ref[name]) <= PARAM_RTOL, (key, name)
        assert tuple(qp["wscale"].shape) == (qp["q"].shape[3],)
        n += 1
    assert n == 3 * tenc.BLOCKS[50][stage] + 1  # conv1-3 of every block and the projection
    assert run["tq"]["stem"] is run["tp"]["stem"]  # the stem stays as it is


@pytest.mark.parametrize("stage", range(4))
def test_calibrate_matches_captionax(run, stage):
    for b, rec in enumerate(run["tscales"]["stages"][stage]):
        ref = run["jscales"]["stages"][stage][b]
        assert set(rec) == set(ref)
        for name, v in rec.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            assert _rel(v.numpy(), ref[name]) <= CALIB_RTOL, (stage, b, name)
        if "downsample" in rec:
            assert rec["downsample"] is rec["conv1"]


QCONV_CASES = {"1x1": (1, 1, 40, 24), "1x1_stride2": (1, 2, 40, 24),
               "3x3": (3, 1, 16, 24), "3x3_stride2": (3, 2, 16, 24)}


@pytest.mark.parametrize("case", sorted(QCONV_CASES))
def test_qconv_int32_sums_exact(case):
    """The same int8 input through both ``_qconv``s with ascale = wscale = 1
    and bias 0 in f32: the dequantized output is the int32 sum itself
    (|sum| < 2^24), so the two must be exactly equal, and equal to
    ``int8_conv``'s int32 output."""
    kh, stride, cin, cout = QCONV_CASES[case]
    rs = np.random.RandomState(kh * 10 + stride)
    qx = rs.randint(-127, 128, (2, 9, 11, cin)).astype(np.float32)
    q = rs.randint(-127, 128, (kh, kh, cin, cout)).astype(np.int8)
    one = np.ones((cout,), np.float32)
    jqp = {"q": jnp.asarray(q), "wscale": jnp.asarray(one), "bias": jnp.zeros(cout),
           "ascale": jnp.float32(1.0)}
    tqp = {"q": torch.from_numpy(q), "wscale": torch.from_numpy(one),
           "bias": torch.zeros(cout), "ascale": torch.tensor(1.0)}
    ref = np.asarray(jenc._qconv(jnp.asarray(qx), jqp, stride, jnp.float32))
    got = tenc._qconv(torch.from_numpy(qx), tqp, stride, torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    sums = tenc.int8_conv(torch.from_numpy(qx).to(torch.int8), torch.from_numpy(q), stride)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), ref.astype(np.int64))


def test_int8_matmul_plain_is_exact():
    """The plain int8 product against integer arithmetic at ResNet-152's
    deepest contraction (3x3 x 512 = 4608) and the extreme values."""
    rs = np.random.RandomState(3)
    a = rs.randint(-127, 128, (5, 4608)).astype(np.int8)
    a[0] = 127
    b = rs.randint(-127, 128, (4608, 3)).astype(np.int8)
    b[:, 0] = 127
    got = tenc.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert int(got[0, 0]) == 127 * 127 * 4608


@pytest.mark.parametrize("route", ("static", "dynamic"))
def test_trunk_matches_captionax(run, route):
    got, ref = run[f"t_{route}"], run[f"j_{route}"]
    assert got.shape == ref.shape == (1, 2, 2, 2048) and got.dtype == np.float32
    assert _rel(got, ref) <= INT8_TRUNK_TOL


@pytest.mark.parametrize("route", ("static", "dynamic"))
def test_trunk_within_captionax_bounds_of_f32(run, route):
    q, f32 = run[f"t_{route}"], run["f32"]
    assert np.abs(q - f32).mean() / (np.abs(f32).mean() + 1e-6) < F32_MEAN_REL
    cos = float(q.ravel() @ f32.ravel() / (np.linalg.norm(q) * np.linalg.norm(f32) + 1e-12))
    assert cos > F32_COSINE


def test_encoder_cnn_int8_tokens(run):
    toks = tenc.encoder_cnn_int8(run["tq"], run["x"], torch.float32)
    assert tuple(toks.shape) == (1, 4, 2048)
    np.testing.assert_array_equal(toks.numpy(), run["t_static"].reshape(1, 4, 2048))
    ref = jenc.encoder_cnn_int8(run["jq"], jnp.asarray(run["x"].numpy()), compute_dtype=jnp.float32)
    assert _rel(toks.numpy(), ref) <= INT8_TRUNK_TOL


def test_bf16_trunk_is_finite_and_close(run):
    """The served compute dtype: bf16 residual adds and ReLUs over the same
    int8 convs stay within captionax's bounds of the f32 encoder."""
    q = tenc.resnet_apply_int8(run["tq"], run["x"], torch.bfloat16).numpy()
    f32 = run["f32"]
    assert q.dtype == np.float32 and np.isfinite(q).all()
    assert np.abs(q - f32).mean() / (np.abs(f32).mean() + 1e-6) < F32_MEAN_REL


def test_rejects_an_unknown_compute_dtype(run):
    with pytest.raises(ValueError, match="compute dtype"):
        tenc.resnet_apply_int8(run["tq"], run["x"], torch.float16)
