"""The port's optimizer in chunked passes against its whole-tree route.

``whole_tree_step`` below is the optimizer's earlier route, kept verbatim
as the reference: every leaf of the tree through the clip, the moments,
the update and ``apply_if_finite`` at once.  The chunked route (a chunk of
7 elements, which splits every leaf but the smallest) must give bit-equal
parameters, moments and counters over a run of steps that holds a plain
step, a clipped one, a dropped non-finite one, a new learning rate and an
applied non-finite one (after 100 in a row), with and without donation
(the in-place route).  ``uniform`` is held to its earlier expression bit
for bit.  No JAX here: the optax comparisons are in ``test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

from captionax_torch.models.layers import uniform
from captionax_torch.train import state as tstate

torch.set_num_threads(1)
CHUNK = 7


def whole_tree_step(grads, state, tx):
    """The earlier ``Optimizer.update`` + ``apply_gradients``, verbatim."""
    B1, B2, EPS, EPS_ROOT = tstate.B1, tstate.B2, tstate.EPS, tstate.EPS_ROOT
    os = state.opt_state
    g = tstate.tree_leaves(grads)
    dev = g[0].device
    finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
    notfinite = torch.where(finite, torch.zeros_like(os.notfinite_count), os.notfinite_count + 1)
    ok = finite | (notfinite > tstate.MAX_CONSECUTIVE_ERRORS)
    total = torch.where(finite, os.total_notfinite, os.total_notfinite + 1)
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
    below = norm < tx.clip_norm
    g = [torch.where(below, x, (x / norm.to(x.dtype)) * tx.clip_norm) for x in g]
    adam = os.adam
    mu = [(1 - B1) * x + B1 * m for x, m in zip(g, tstate.tree_leaves(adam.mu))]
    nu = [(1 - B2) * (x * x) + B2 * v for x, v in zip(g, tstate.tree_leaves(adam.nu))]
    count = adam.count + 1
    bc1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=dev), count)
    bc2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=dev), count)
    lr = os.hyperparams["learning_rate"]
    upd = [(m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype) + EPS_ROOT) + EPS)
           for m, v in zip(mu, nu)]
    upd = [-lr * u for u in upd]
    keep = lambda new, old: [torch.where(ok, a, b) for a, b in zip(new, old)]
    new_adam = tstate.AdamState(
        torch.where(ok, count, adam.count),
        tstate.tree_unflatten(adam.mu, keep(mu, tstate.tree_leaves(adam.mu))),
        tstate.tree_unflatten(adam.nu, keep(nu, tstate.tree_leaves(adam.nu))))
    upd = [torch.where(ok, u, torch.zeros_like(u)) for u in upd]
    params = [(p + u).to(p.dtype) for p, u in zip(tstate.tree_leaves(state.params), upd)]
    return tstate.TrainState(tstate.tree_unflatten(state.params, params),
                             tstate.OptState(os.hyperparams, notfinite, total, new_adam),
                             state.step + 1)


def params0():
    rs = np.random.RandomState(0)
    tree = {"a": {"w": rs.randn(6, 5), "b": rs.randn(5)},
            "c": [rs.randn(4), rs.randn(3, 2)], "d": rs.randn(23)}
    return tstate.tree_map(lambda x: torch.from_numpy(x.astype(np.float32)), tree)


def grads(seed, scale=1.0, nan=False):
    rs = np.random.RandomState(100 + seed)
    g = tstate.tree_map(lambda x: torch.from_numpy(
        (rs.randn(*x.shape) * scale).astype(np.float32)), params0())
    if nan:
        g["a"]["w"][2, 3] = float("nan")
    return g


# (gradient scale, NaN, learning rate set before the step, repeats)
STEPS = [(0.1, False, None, 1), (10.0, False, None, 1), (0.1, True, None, 1),
         (0.3, False, 2e-2, 1), (20.0, False, None, 1), (0.2, True, None, 101),
         (0.5, False, None, 1)]


def leaves_of(state):
    adam = state.opt_state.adam
    return (tstate.tree_leaves(state.params) + tstate.tree_leaves(adam.mu)
            + tstate.tree_leaves(adam.nu)
            + [adam.count, state.opt_state.notfinite_count,
               state.opt_state.total_notfinite, state.step])


def same_bits(a, b) -> bool:
    """Equal dtypes, shapes and bits (NaN payloads included)."""
    bits = lambda t: t.reshape(-1).view(torch.int32) if t.dtype == torch.float32 else t
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


def assert_bit_equal(got, ref, what):
    for i, (a, b) in enumerate(zip(leaves_of(got), leaves_of(ref))):
        assert same_bits(a, b), (what, i)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(tstate, "CHUNK", CHUNK)


@pytest.mark.parametrize("donate", [False, True], ids=["new tensors", "donated"])
def test_chunked_steps_bit_equal_to_whole_tree(donate):
    tx = tstate.Optimizer(1e-2, clip_norm=5.0, donate=donate)
    ref = tstate.create_train_state(params0(), tx, device="cpu")
    got = tstate.create_train_state(params0(), tx, device="cpu")
    clipped = 0
    for i, (scale, nan, lr, repeats) in enumerate(STEPS):
        if lr is not None:
            ref, got = tstate.set_lr(ref, lr), tstate.set_lr(got, lr)
        for r in range(repeats):
            g = grads(i, scale, nan)
            norm = torch.sqrt(sum(torch.sum(x * x) for x in tstate.tree_leaves(g)))
            clipped += bool(norm >= 5.0)
            kept = [x.clone() for x in tstate.tree_leaves(got.params)]
            ref = whole_tree_step(g, ref, tx)
            mine = tstate.tree_map(torch.clone, g)
            new = got.apply_gradients(mine, tx)
            if not donate:  # the old state and the gradients stay as they were
                for a, b in zip(kept, tstate.tree_leaves(got.params)):
                    assert same_bits(a, b)
                for a, b in zip(tstate.tree_leaves(g), tstate.tree_leaves(mine)):
                    assert same_bits(a, b)
            got = new
            assert_bit_equal(got, ref, (i, r))
    assert clipped >= 2
    assert int(got.opt_state.total_notfinite) == 102
    assert int(got.opt_state.adam.count) == 6  # step 2 and 100 of step 5 dropped
    assert bool(torch.isnan(got.params["a"]["w"]).any())


def test_donated_step_writes_in_place():
    tx = tstate.Optimizer(1e-2, donate=True)
    state = tstate.create_train_state(params0(), tx, device="cpu")
    ptrs = [x.data_ptr() for x in leaves_of(state)[:-4]]
    g = grads(0)
    gptrs = [x.data_ptr() for x in tstate.tree_leaves(g)]
    new = state.apply_gradients(g, tx)
    assert [x.data_ptr() for x in leaves_of(new)[:-4]] == ptrs
    upd, _ = tx.update(grads(1), new.opt_state)
    assert all(u.dtype == torch.float32 for u in tstate.tree_leaves(upd))
    assert [x.data_ptr() for x in tstate.tree_leaves(g)] == gptrs


def test_chunks_cover_each_leaf_once():
    x = torch.arange(23.0)
    pieces = list(tstate._chunked(x, x.clone()))
    assert [len(a) for a, _ in pieces] == [7, 7, 7, 2]
    assert torch.equal(torch.cat([a for a, _ in pieces]), x)
    t = torch.arange(12.0).reshape(3, 4).t()  # not contiguous: one piece, whole
    (whole,) = list(tstate._chunked(t, t.clone()))
    assert whole[0] is t


@pytest.mark.parametrize("shape,bound", [((7, 5), 0.3), ((1000,), 1.0 / np.sqrt(200))])
def test_uniform_same_numbers_as_before(shape, bound):
    old = torch.rand(shape, generator=torch.Generator().manual_seed(3)) * (2 * bound) - bound
    new = uniform(torch.Generator().manual_seed(3), shape, bound, device="cpu")
    assert torch.equal(old, new)


def test_tree_unflatten_leaves_no_cycle():
    """A tree made by tree_unflatten frees its leaves' list as soon as the
    tree goes: no reference cycle waits for the garbage collector (at full
    width the list is a step's gradients, 14.6 GB)."""
    import gc
    import weakref

    class Leaves(list):
        pass

    gc.disable()
    try:
        leaves = Leaves(tstate.tree_leaves(params0()))
        ref = weakref.ref(leaves)
        tree = tstate.tree_unflatten(params0(), leaves)
        assert tstate.tree_leaves(tree)[0] is leaves[0]
        del leaves, tree
        assert ref() is None
    finally:
        gc.enable()
