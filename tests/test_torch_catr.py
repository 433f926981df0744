"""The port's CATR (captionax_torch/models/catr.py) on the CPU against
captionax's, on the same weights (captionax's init moved by seeded noise,
carried with from_jax_params) and the same numpy inputs.  f32:
``catr_encode``, ``catr_decode_logits`` and ``catr_forward`` within 1e-5
of their largest entry in both norm orders; the teacher-forced loss and
every gradient within 1e-5 (``jax.grad``); ``catr_greedy``'s ids equal
(the port runs step t over the buffer's first t + 1 positions, captionax
over the whole buffer); the encoder and decoder hooks, given the
sequential stacks, equal the default route."""

import jax
import numpy as np
import pytest
import torch

from captionax.models import catr as jcatr
from captionax.train.losses import cross_entropy_loss as j_ce
from captionax_torch.interop import from_jax_params
from captionax_torch.models import catr as tcatr
from captionax_torch.models.transformer import detr_decoder_layer, detr_encoder_layer
from captionax_torch.train.losses import cross_entropy_loss
from captionax_torch.train.state import tree_leaves
from captionax_torch.train.steps import _value_and_grad
from tests.test_torch_detr import SHARE, T_, assert_grads, assert_share, jittered

torch.set_num_threads(1)
V, HIDDEN, HEADS, FF, LAYERS, IMG, B, T = 37, 32, 4, 48, 2, 16, 3, 8
GRID = (3, 2)
R = GRID[0] * GRID[1]


@pytest.fixture(scope="module")
def model():
    init = jcatr.catr_init(jax.random.PRNGKey(0), V, hidden=HIDDEN, num_heads=HEADS, ff=FF,
                           enc_layers=LAYERS, dec_layers=LAYERS, max_position=16,
                           image_dim=IMG)
    p = jittered(init, 1)
    return p, from_jax_params(p, "cpu")


def feats(seed, rows=B):
    return np.abs(np.random.RandomState(seed).randn(rows, R, IMG)).astype(np.float32)


def captions(seed, rows=B, cols=T):
    return np.random.RandomState(seed).randint(0, V, (rows, cols)).astype(np.int32)


@pytest.mark.parametrize("heads", [HEADS, None])
@pytest.mark.parametrize("pre_norm", [True, False])
def test_catr_encode_decode_forward(model, pre_norm, heads):
    jp, tp = model
    f, caps = feats(2), captions(3)
    ref_mem = jcatr.catr_encode(jp, f, GRID, pre_norm, num_heads=heads)
    mem = tcatr.catr_encode(tp, T_(f), GRID, pre_norm, num_heads=heads)
    assert_share(mem, ref_mem, what="memory")
    ref_logits = jcatr.catr_decode_logits(jp, np.asarray(ref_mem), caps, GRID, pre_norm,
                                          num_heads=heads)
    logits = tcatr.catr_decode_logits(tp, T_(ref_mem), T_(caps).long(), GRID, pre_norm,
                                      num_heads=heads)
    assert_share(logits, ref_logits, what="logits")
    ref = jcatr.catr_forward(jp, f, caps, GRID, pre_norm, num_heads=heads)
    got = tcatr.catr_forward(tp, T_(f), T_(caps).long(), GRID, pre_norm, num_heads=heads)
    assert tuple(got.shape) == (B, T, V)
    assert_share(got, ref, what="forward")


@pytest.mark.parametrize("pre_norm", [True, False])
def test_catr_causal(model, pre_norm):
    """Changing token t leaves the logits before t alone."""
    _, tp = model
    f, caps = T_(feats(4)), T_(captions(5)).long()
    base = tcatr.catr_forward(tp, f, caps, GRID, pre_norm)
    for t in (3, T - 1):
        other = caps.clone()
        other[:, t] = (other[:, t] + 1) % V
        moved = tcatr.catr_forward(tp, f, other, GRID, pre_norm)
        torch.testing.assert_close(moved[:, :t], base[:, :t], rtol=1e-6, atol=1e-6)
        assert not torch.allclose(moved[:, t], base[:, t])


@pytest.mark.parametrize("pre_norm", [True, False])
def test_catr_loss_and_gradients(model, pre_norm):
    jp, tp = model
    f, caps = feats(6), captions(7, cols=T + 1)
    caps[0, 5:] = 0  # padded targets are masked

    def jloss(p):
        return j_ce(jcatr.catr_forward(p, f, caps[:, :-1], GRID, pre_norm, num_heads=HEADS),
                    caps[:, 1:])

    def tloss(p):
        c = T_(caps).long()
        return cross_entropy_loss(tcatr.catr_forward(p, T_(f), c[:, :-1], GRID, pre_norm,
                                                     num_heads=HEADS), c[:, 1:])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = _value_and_grad(tloss, tp)
    assert abs(float(loss) - float(ref_loss)) <= SHARE * abs(float(ref_loss))
    assert_grads(grads, ref_grads)


@pytest.mark.parametrize("heads", [HEADS, None])
@pytest.mark.parametrize("max_len", [2, 10])
def test_catr_greedy(model, max_len, heads):
    jp, tp = model
    f = feats(8, rows=7)
    ref = np.asarray(jcatr.catr_greedy(jp, f, max_len=max_len, grid_hw=GRID,
                                       num_heads=heads))
    got = tcatr.catr_greedy(tp, T_(f), max_len=max_len, grid_hw=GRID, num_heads=heads)
    assert tuple(got.shape) == (7, max_len) and (got[:, 0] == 1).all()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_catr_greedy_ignores_eos(model):
    _, tp = model
    f = T_(feats(9, rows=4))
    a = tcatr.catr_greedy(tp, f, max_len=6, grid_hw=GRID, eos_id=2)
    b = tcatr.catr_greedy(tp, f, max_len=6, grid_hw=GRID, eos_id=-1)
    assert torch.equal(a, b)


def test_hooks_equal_the_default_route(model):
    _, tp = model
    f, caps = T_(feats(10)), T_(captions(11)).long()

    def encoder_fn(layers, x, heads, pos):
        for layer in layers:
            x = detr_encoder_layer(layer, x, pos, heads)
        return x

    def decoder_fn(layers, tgt, memory, tgt_pos, pos, heads, tmask):
        for layer in layers:
            tgt = detr_decoder_layer(layer, tgt, memory, tgt_pos, pos, heads, tgt_mask=tmask)
        return tgt

    ref = tcatr.catr_forward(tp, f, caps, GRID)
    assert torch.equal(tcatr.catr_forward(tp, f, caps, GRID, encoder_fn=encoder_fn,
                                          decoder_fn=decoder_fn), ref)


@pytest.mark.parametrize("hidden", [16, 32, 64, 256])
def test_num_heads_rule(hidden):
    """hidden // 32, at least 1: 1, 1, 2, 8."""
    table = np.zeros((3, hidden), np.float32)
    assert tcatr._num_heads({"word_emb": torch.from_numpy(table)}) == jcatr._num_heads(
        {"word_emb": table}) == max(hidden // 32, 1)


def test_catr_init_shapes():
    ref = jax.tree_util.tree_map(np.asarray, jcatr.catr_init(
        jax.random.PRNGKey(0), V, hidden=HIDDEN, num_heads=HEADS, ff=FF, enc_layers=LAYERS,
        dec_layers=3, image_dim=IMG))
    got = tcatr.catr_init(torch.Generator().manual_seed(0), V, hidden=HIDDEN, num_heads=HEADS,
                          ff=FF, enc_layers=LAYERS, dec_layers=3, image_dim=IMG, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(got)] == [
        tuple(x.shape) for x in tree_leaves(from_jax_params(ref, "cpu"))]
    assert len(got["encoder"]) == LAYERS and len(got["decoder"]) == 3
    assert tcatr._num_heads(got) == jcatr._num_heads(ref) == 1
