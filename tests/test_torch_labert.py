"""The port's LaBERT (captionax_torch/models/labert.py) on the CPU against
captionax's, on the same weights (captionax's init moved by seeded noise,
carried with from_jax_params), the same numpy inputs and captionax's mask
draws.  f32: logits within 1e-5 of their largest entry; the loss and every
gradient within 1e-5 (``jax.grad``); ``length_bucket``, ``mask_tokens``
and ``mask_predict_decode``'s ids equal.  The model runs with 2 heads at
hidden 32, where ``hidden // 64`` gives 1: captionax's decode passes no
head count, so it decodes with 1 head, and so does the port's."""

import jax
import numpy as np
import pytest
import torch

from captionax.models import labert as jlab
from captionax_torch.interop import from_jax_params
from captionax_torch.models import labert as tlab
from captionax_torch.models.transformer import bert_encoder
from captionax_torch.train.state import tree_leaves
from captionax_torch.train.steps import _value_and_grad
from tests.test_torch_detr import SHARE, T_, assert_grads, assert_share, jittered

torch.set_num_threads(1)
V, HIDDEN, LAYERS, HEADS, FF, IMG, R, B, T = 41, 32, 2, 2, 64, 16, 5, 4, 9
MASK_ID = V - 1


@pytest.fixture(scope="module")
def model():
    init = jlab.labert_init(jax.random.PRNGKey(0), V, hidden=HIDDEN, num_layers=LAYERS,
                            num_heads=HEADS, intermediate=FF, image_dim=IMG)
    p = jittered(init, 1)
    return p, from_jax_params(p, "cpu")


def tokens(seed, all_pad_row=True):
    """ids [B, T] in 1..V-2 with each row padded (0) after a random length;
    row 1 all pad when ``all_pad_row``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, V - 1, (B, T)).astype(np.int32)
    lengths = rs.randint(1, T + 1, B)
    lengths[0] = T
    if all_pad_row:
        lengths[1] = 0
    ids[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return ids


def types_for(ids):
    lengths = (ids != 0).sum(axis=1)
    return np.asarray([tlab.length_bucket(int(n)) + 2 for n in lengths],
                      np.int32)[:, None].repeat(ids.shape[1], 1)


def feats(seed, rows=B):
    return np.abs(np.random.RandomState(seed).randn(rows, R, IMG)).astype(np.float32)


def jax_draws(key, rows, cols, min_frac=0.1):
    """captionax's mask_tokens draws from ``rng``: (ratio, scores)."""
    k1, k2 = jax.random.split(key)
    ratio = jax.random.uniform(k1, (rows, 1), minval=min_frac, maxval=1.0)
    return T_(ratio), T_(jax.random.uniform(k2, (rows, cols)))


def test_length_bucket():
    assert [tlab.length_bucket(n) for n in range(71)] == [
        jlab.length_bucket(n) for n in range(71)]
    assert tlab.LENGTH_BOUNDARIES == jlab.LENGTH_BOUNDARIES


@pytest.mark.parametrize("heads", [HEADS, None])
@pytest.mark.parametrize("image_times_3", [True, False])
def test_labert_forward(model, image_times_3, heads):
    jp, tp = model
    ids = tokens(2)
    attn = (ids != 0).astype(np.float32)
    f, types = feats(3), types_for(ids)
    ref = jlab.labert_forward(jp, f, ids, types, attn, image_times_3, num_heads=heads)
    got = tlab.labert_forward(tp, T_(f), T_(ids).long(), T_(types).long(), T_(attn),
                              image_times_3, num_heads=heads)
    assert tuple(got.shape) == (B, R + T, V)
    assert_share(got, ref)


def test_encoder_hook_is_the_default_route(model):
    """``encoder_fn=bert_encoder`` runs the same products as the default."""
    _, tp = model
    ids = tokens(4)
    args = (T_(feats(5)), T_(ids).long(), T_(types_for(ids)).long(),
            T_((ids != 0).astype(np.float32)))
    assert torch.equal(tlab.labert_forward(tp, *args, num_heads=HEADS),
                       tlab.labert_forward(tp, *args, num_heads=HEADS, encoder_fn=bert_encoder))


def test_decode_head_count(model):
    """No head count means hidden // 64 = 1 here, not the model's 2."""
    _, tp = model
    assert tlab._num_heads(tp) == jlab._num_heads(model[0]) == 1
    ids = tokens(6)
    args = (T_(feats(7)), T_(ids).long(), T_(types_for(ids)).long(),
            T_((ids != 0).astype(np.float32)))
    default = tlab.labert_forward(tp, *args)
    assert torch.equal(default, tlab.labert_forward(tp, *args, num_heads=1))
    assert not torch.allclose(default, tlab.labert_forward(tp, *args, num_heads=HEADS))


@pytest.mark.parametrize("hidden", [32, 64, 128, 768])
def test_num_heads_rule(hidden):
    """hidden // 64, at least 1: 1, 1, 2, 12."""
    table = np.zeros((3, hidden), np.float32)
    assert tlab._num_heads({"word_emb": torch.from_numpy(table)}) == jlab._num_heads(
        {"word_emb": table}) == max(hidden // 64, 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mask_tokens(seed):
    ids = tokens(10 + seed)
    key = jax.random.PRNGKey(seed)
    ref_ids, ref_mask = jlab.mask_tokens(key, ids, MASK_ID)
    got_ids, got_mask = tlab.mask_tokens(T_(ids).long(), MASK_ID, draws=jax_draws(key, B, T))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    # the all-pad row still masks its position 0
    assert got_mask[1].tolist() == [True] + [False] * (T - 1)
    assert got_mask.any(dim=1).all()


def test_mask_tokens_own_draws():
    """Without draws the port draws from its generator: the ratio in
    [0.1, 1), the same masks for the same seed."""
    ids = T_(tokens(20)).long()
    ratio, scores = tlab.mask_draws(torch.Generator().manual_seed(3), B, T, device="cpu")
    assert ratio.shape == (B, 1) and scores.shape == (B, T)
    assert (ratio >= 0.1).all() and (ratio < 1).all() and (scores < 1).all()
    a = tlab.mask_tokens(ids, MASK_ID, generator=torch.Generator().manual_seed(5))
    b = tlab.mask_tokens(ids, MASK_ID, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("heads", [HEADS, None])
def test_labert_loss_and_gradients(model, heads):
    jp, tp = model
    ids = tokens(30)
    f, types = feats(31), types_for(ids)
    key = jax.random.PRNGKey(7)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jlab.labert_loss(p, f, ids, types, key, MASK_ID, num_heads=heads)))(jp)
    loss, grads = _value_and_grad(
        lambda p: tlab.labert_loss(p, T_(f), T_(ids).long(), T_(types).long(),
                                   jax_draws(key, B, T), MASK_ID, num_heads=heads), tp)
    assert abs(float(loss) - float(ref_loss)) <= SHARE * abs(float(ref_loss))
    assert_grads(grads, ref_grads)


@pytest.mark.parametrize("length,iterations", [(12, 10), (7, 3), (5, 1)])
def test_mask_predict_decode(model, length, iterations):
    jp, tp = model
    f = feats(40, rows=6)
    ref = np.asarray(jlab.mask_predict_decode(jp, f, MASK_ID, length=length,
                                              iterations=iterations))
    got = tlab.mask_predict_decode(tp, T_(f), MASK_ID, length=length, iterations=iterations)
    assert tuple(got.shape) == (6, length)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_labert_init_shapes():
    ref = jax.tree_util.tree_map(np.asarray, jlab.labert_init(
        jax.random.PRNGKey(0), V, hidden=HIDDEN, num_layers=LAYERS, num_heads=HEADS,
        intermediate=FF, image_dim=IMG))
    got = tlab.labert_init(torch.Generator().manual_seed(0), V, hidden=HIDDEN,
                           num_layers=LAYERS, num_heads=HEADS, intermediate=FF, image_dim=IMG,
                           device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(got)] == [
        tuple(x.shape) for x in tree_leaves(from_jax_params(ref, "cpu"))]
    assert abs(float(got["word_emb"].std()) - 0.02) < 0.005
