"""Weight carry between captionax parameter trees and the PyTorch port:
from_jax_params -> to_numpy_tree must give back every leaf bit for bit,
with the JAX package's shapes and layout (tolerance: none, bit-exact)."""

import jax
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax_torch.interop import from_jax_params, to_device, to_numpy_tree

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


TREES = {
    "attention_gru": lambda: jdec.attention_gru_init(
        jax.random.PRNGKey(0), 32, 16, 16, 16, 50),
    "attention_gru_2_layers": lambda: jdec.attention_gru_init(
        jax.random.PRNGKey(1), 32, 16, 16, 16, 50, num_layers=2),
    "hypernet": lambda: j_hypernet_init(
        jax.random.PRNGKey(2), hyper_emb=16, input_dim=32, hidden_dim=16),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_round_trip_bit_exact(name):
    tree = jax.tree_util.tree_map(np.asarray, TREES[name]())
    tt = from_jax_params(tree, device="cpu")
    back = to_numpy_tree(tt)
    src, dst, mid = list(_leaves(tree)), list(_leaves(back)), list(_leaves(tt))
    assert [p for p, _ in src] == [p for p, _ in dst] == [p for p, _ in mid]
    for (path, a), (_, t), (_, b) in zip(src, mid, dst):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", path
        assert tuple(t.shape) == a.shape, path
        assert b.dtype == a.dtype, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_layout_is_kept():
    tree = jax.tree_util.tree_map(np.asarray, TREES["attention_gru"]())
    tt = from_jax_params(tree, device="cpu")
    assert tuple(tt["fc"]["w"].shape) == (16, 50)          # linear: [in, out]
    assert tuple(tt["gru"]["w_ih"].shape) == (48, 32)      # GRU: [3H, In]
    assert tuple(tt["attention"]["v_a"]["w"].shape) == (16, 1)


def test_dtype_cast_and_to_device():
    tree = jax.tree_util.tree_map(np.asarray, TREES["hypernet"]())
    tt = from_jax_params(tree, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 for _, t in _leaves(tt))
    same = to_device(tt, "cpu")
    assert all(a is b for (_, a), (_, b) in zip(_leaves(tt), _leaves(same)))
