"""The port's BERT building blocks (captionax_torch/models/transformer.py)
on the CPU against captionax's, on the same weights (carried with
from_jax_params) and the same numpy inputs.  f32 throughout: outputs
within rtol 1e-5, atol 1e-5 (sums taken in another order); gradients
within the train tests' bound (``grad_tol``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import transformer as jtr
from captionax_torch.interop import from_jax_params
from captionax_torch.models import transformer as ttr
from captionax_torch.train import state as tstate

torch.set_num_threads(1)
B, T, D, HEADS, FF, LAYERS = 3, 7, 32, 4, 64, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def x_in(seed, shape=(B, T, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def additive_mask(seed):
    """[B, 1, 1, T]: 0 kept, -10000 masked; every row keeps its first token."""
    keep = np.random.RandomState(seed).rand(B, T) < 0.6
    keep[:, 0] = True
    return ((1.0 - keep.astype(np.float32)) * -10000.0)[:, None, None, :]


def grad_tol(ref):
    """tests/test_torch_train.py's gradient tolerance: rtol 2e-4, atol
    max(2e-5 * scale, 1e-6), the floor for a gradient that is exactly 0
    (the key bias's: softmax ignores a shift shared by every key) and
    comes out as float noise in both frameworks."""
    scale = max(float(np.abs(np.asarray(ref)).max()), 1e-3)
    return dict(rtol=2e-4, atol=max(2e-5 * scale, 1e-6))


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


def test_layer_norm_population_variance():
    p = {"gamma": np.random.RandomState(1).rand(D).astype(np.float32) + 0.5,
         "beta": np.random.RandomState(2).randn(D).astype(np.float32)}
    x = x_in(3) * 5 + 2
    close(ttr.layer_norm(carry(p), torch.from_numpy(x)), jtr.layer_norm(p, x))
    close(ttr.layer_norm(carry(p), torch.from_numpy(x), eps=1e-3), jtr.layer_norm(p, x, 1e-3))


def test_layer_norm_init():
    p = ttr.layer_norm_init(D, device="cpu")
    assert torch.equal(p["gamma"], torch.ones(D)) and torch.equal(p["beta"], torch.zeros(D))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kv_dim", [None, 24])
def test_mha(masked, kv_dim):
    p = np_tree(jtr.mha_init(jax.random.PRNGKey(0), D, HEADS, kv_dim))
    q = x_in(4)
    kv = x_in(5, (B, T + 2, kv_dim or D))
    mask = None
    if masked:
        keep = np.random.RandomState(6).rand(B, T + 2) < 0.6
        keep[:, 0] = True
        mask = ((1.0 - keep.astype(np.float32)) * -10000.0)[:, None, None, :]
    ref = jtr.mha(p, q, kv, HEADS, mask)
    got = ttr.mha(carry(p), torch.from_numpy(q), torch.from_numpy(kv), HEADS,
                  None if mask is None else torch.from_numpy(mask))
    close(got, ref)


def test_mha_init_shapes():
    g = torch.Generator().manual_seed(0)
    p = ttr.mha_init(g, D, HEADS, kv_dim=24, device="cpu")
    ref = np_tree(jtr.mha_init(jax.random.PRNGKey(0), D, HEADS, 24))
    assert ([tuple(a.shape) for a in tstate.tree_leaves(p)]
            == [np.shape(b) for b in jax.tree_util.tree_leaves(ref)])


def test_ffn_uses_tanh_gelu():
    p = np_tree(jtr.ffn_init(jax.random.PRNGKey(1), D, FF))
    x = x_in(7) * 3
    close(ttr.ffn(carry(p), torch.from_numpy(x)), jtr.ffn(p, x))
    y = torch.from_numpy(x)
    assert not torch.allclose(ttr.gelu(y), torch.nn.functional.gelu(y), rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_layer(masked):
    p = np_tree(jtr.bert_layer_init(jax.random.PRNGKey(2), D, HEADS, FF))
    x = x_in(8)
    mask = additive_mask(9) if masked else None
    close(ttr.bert_layer(carry(p), torch.from_numpy(x), HEADS,
                         None if mask is None else torch.from_numpy(mask)),
          jtr.bert_layer(p, x, HEADS, mask))


@pytest.mark.parametrize("masked", [False, True])
def test_bert_encoder(masked):
    p = np_tree(jtr.bert_encoder_init(jax.random.PRNGKey(3), LAYERS, D, HEADS, FF))
    x = x_in(10)
    mask = additive_mask(11) if masked else None
    close(ttr.bert_encoder(carry(p), torch.from_numpy(x), HEADS,
                           None if mask is None else torch.from_numpy(mask)),
          jtr.bert_encoder(p, x, HEADS, mask))


@pytest.mark.parametrize("masked", [False, True])
def test_bert_encoder_gradients(masked):
    """jax.grad of a scalar of bert_encoder against autograd, every weight
    and the input."""
    p = np_tree(jtr.bert_encoder_init(jax.random.PRNGKey(4), LAYERS, D, HEADS, FF))
    x = x_in(12)
    mask = additive_mask(13) if masked else None
    w = np.random.RandomState(14).randn(B, T, D).astype(np.float32)

    def jloss(q, xx):
        return jnp.sum(jnp.tanh(jtr.bert_encoder(q, xx, HEADS, mask)) * w)

    ref_p, ref_x = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = carry(p)
    leaves = [a.requires_grad_(True) for a in tstate.tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ttr.bert_encoder(tp, tx, HEADS, None if mask is None else torch.from_numpy(mask))
    loss = torch.sum(torch.tanh(out) * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, leaves + [tx])
    refs = jax.tree_util.tree_leaves(ref_p) + [ref_x]
    assert len(grads) == len(refs)
    for got, ref in zip(grads, refs):
        close(got, ref, **grad_tol(ref))


def test_bert_encoder_init_structure():
    g = torch.Generator().manual_seed(0)
    p = ttr.bert_encoder_init(g, LAYERS, D, HEADS, FF, device="cpu")
    ref = np_tree(jtr.bert_encoder_init(jax.random.PRNGKey(0), LAYERS, D, HEADS, FF))
    got_paths = [tuple(a.shape) for a in tstate.tree_leaves(p)]
    ref_paths = [np.shape(a) for a in jax.tree_util.tree_leaves(ref)]
    assert got_paths == ref_paths
    # the linears keep nn.Linear's bound 1/sqrt(in)
    w1 = p[0]["ffn"]["w1"]["w"]
    assert float(w1.abs().max()) <= 1 / np.sqrt(D)
