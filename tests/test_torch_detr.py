"""The port's DETR layers (captionax_torch/models/transformer.py) on the
CPU against captionax's, on the same weights (captionax's init, every leaf
then moved by seeded noise so no layer norm is the identity, carried with
from_jax_params) and the same numpy inputs.  f32: outputs within 1e-5 of
the output's largest entry, gradients within 1e-5 of each leaf's largest
entry; ``causal_mask`` equal; ``sine_position_2d`` within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import transformer as jtr
from captionax_torch.interop import from_jax_params
from captionax_torch.models import transformer as ttr
from captionax_torch.train.state import tree_leaves
from captionax_torch.train.steps import _value_and_grad

torch.set_num_threads(1)
B, T, R, D, HEADS, FF = 3, 6, 9, 32, 4, 48
SHARE = 1e-5


def jittered(tree, seed):
    """captionax's init tree as numpy, every leaf plus N(0, 0.1) noise."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rs.randn(*np.shape(x))).astype(np.float32), tree)


def x_in(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_share(got, ref, share=SHARE, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = float(np.abs(got - ref).max())
    assert err <= share * scale, (what, err, scale)


def pad_mask(seed, rows, keys):
    """[rows, 1, 1, keys] additive: 0 kept, -10000 masked; key 0 kept."""
    keep = np.random.RandomState(seed).rand(rows, keys) < 0.6
    keep[:, 0] = True
    return ((1.0 - keep.astype(np.float32)) * -10000.0)[:, None, None, :]


def key_bias(path) -> bool:
    """A key projection's bias: its exact gradient is 0 (softmax ignores a
    shift shared by every key), so both frameworks give float noise."""
    names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    return names[-2:] == ["k", "b"]


def assert_grads(got_tree, ref_tree, share=SHARE):
    """Every gradient within ``share`` of its leaf's largest entry; a key
    bias's (exactly 0) under ``share`` of the tree's largest entry."""
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = tree_leaves(got_tree)
    assert len(got) == len(ref)
    top = max(float(np.abs(np.asarray(r)).max()) for _, r in ref)
    for g, (path, r) in zip(got, ref):
        what = jax.tree_util.keystr(path)
        if key_bias(path):
            assert float(g.abs().max()) <= share * top, (what, float(g.abs().max()), top)
        else:
            assert_share(g, r, share, what)


T_ = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_norm", [True, False])
def test_detr_encoder_layer(pre_norm, masked):
    p = jittered(jtr.detr_encoder_layer_init(jax.random.PRNGKey(1), D, HEADS, FF), 2)
    x, pos = x_in(3, (B, R, D)), x_in(4, (1, R, D))
    mask = pad_mask(5, B, R) if masked else None
    ref = jtr.detr_encoder_layer(p, x, pos, HEADS, pre_norm, mask)
    got = ttr.detr_encoder_layer(from_jax_params(p, "cpu"), T_(x), T_(pos), HEADS, pre_norm,
                                 T_(mask))
    assert_share(got, ref)


DECODER_MASKS = ("none", "tgt", "mem", "both")


@pytest.mark.parametrize("masks", DECODER_MASKS)
@pytest.mark.parametrize("pre_norm", [True, False])
def test_detr_decoder_layer(pre_norm, masks):
    p = jittered(jtr.detr_decoder_layer_init(jax.random.PRNGKey(6), D, HEADS, FF), 7)
    tgt, memory = x_in(8, (B, T, D)), x_in(9, (B, R, D))
    tgt_pos, mem_pos = x_in(10, (1, T, D)), x_in(11, (1, R, D))
    tgt_mask = np.asarray(jtr.causal_mask(T)) if masks in ("tgt", "both") else None
    mem_mask = pad_mask(12, B, R) if masks in ("mem", "both") else None
    ref = jtr.detr_decoder_layer(p, tgt, memory, tgt_pos, mem_pos, HEADS, pre_norm,
                                 tgt_mask=tgt_mask, mem_mask=mem_mask)
    got = ttr.detr_decoder_layer(from_jax_params(p, "cpu"), T_(tgt), T_(memory), T_(tgt_pos),
                                 T_(mem_pos), HEADS, pre_norm, tgt_mask=T_(tgt_mask),
                                 mem_mask=T_(mem_mask))
    assert_share(got, ref)


@pytest.mark.parametrize("pre_norm", [True, False])
def test_detr_stack_gradients(pre_norm):
    """An encoder layer feeding a causal decoder layer: a scalar of the
    output and every weight's gradient against ``jax.grad``."""
    enc = jittered(jtr.detr_encoder_layer_init(jax.random.PRNGKey(13), D, HEADS, FF), 14)
    dec = jittered(jtr.detr_decoder_layer_init(jax.random.PRNGKey(15), D, HEADS, FF), 16)
    src, tgt = x_in(17, (B, R, D)), x_in(18, (B, T, D))
    pos, tgt_pos = x_in(19, (1, R, D)), x_in(20, (1, T, D))
    w = x_in(21, (B, T, D))

    def jloss(p):
        memory = jtr.detr_encoder_layer(p["enc"], src, pos, HEADS, pre_norm)
        y = jtr.detr_decoder_layer(p["dec"], tgt, memory, tgt_pos, pos, HEADS, pre_norm,
                                   tgt_mask=jtr.causal_mask(T))
        return jnp.sum(jnp.tanh(y) * w)

    def tloss(p):
        memory = ttr.detr_encoder_layer(p["enc"], T_(src), T_(pos), HEADS, pre_norm)
        y = ttr.detr_decoder_layer(p["dec"], T_(tgt), memory, T_(tgt_pos), T_(pos), HEADS,
                                   pre_norm, tgt_mask=ttr.causal_mask(T, "cpu"))
        return torch.sum(torch.tanh(y) * T_(w))

    tree = {"enc": enc, "dec": dec}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(tree)
    loss, grads = _value_and_grad(tloss, from_jax_params(tree, "cpu"))
    assert abs(float(loss) - float(ref_loss)) <= SHARE * abs(float(ref_loss))
    assert_grads(grads, ref_grads)


@pytest.mark.parametrize("T_len", [1, 5, 25])
def test_causal_mask(T_len):
    ref = np.asarray(jtr.causal_mask(T_len))
    got = ttr.causal_mask(T_len, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1, T_len, T_len)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min().item() == (-1e9 if T_len > 1 else 0.0)  # -1e9, not -inf


@pytest.mark.parametrize("hwd", [(7, 7, 256), (3, 5, 32)])
def test_sine_position_2d(hwd):
    ref = np.asarray(jtr.sine_position_2d(*hwd))
    got = ttr.sine_position_2d(*hwd, device="cpu")
    assert tuple(got.shape) == ref.shape == (hwd[0] * hwd[1], hwd[2])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_detr_init_shapes(which):
    """The port's init draws the same tree of shapes as captionax's."""
    jinit = getattr(jtr, f"detr_{which}_layer_init")
    tinit = getattr(ttr, f"detr_{which}_layer_init")
    ref = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0), D, HEADS, FF))
    got = tinit(torch.Generator().manual_seed(0), D, HEADS, FF, device="cpu")
    carried = from_jax_params(ref, "cpu")
    assert [tuple(x.shape) for x in tree_leaves(got)] == [
        tuple(x.shape) for x in tree_leaves(carried)]
    for ln in [k for k in got if k.startswith("ln")]:
        assert torch.equal(got[ln]["gamma"], torch.ones(D))
