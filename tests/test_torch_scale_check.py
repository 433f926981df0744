"""The port's ``scale_check`` (captionax_torch/cli/scale_check.py) and the
``model`` axis (``parallel/mesh.py``'s ``Sharding``, ``ColumnShards``,
``RowShards``; ``train.steps.mesh_train_step``) on the CPU.

``--virtual 8 --kind gru --mesh-data 4 --mesh-model 2`` at tiny widths
prints captionax's lines (``data4 x model2``, the fc's ``PartitionSpec``,
``scale_check OK``), as captionax's own run does.  The data x model step
of both kinds, on captionax's initial weights carried with
``from_jax_params`` and placed as scale_check places them, holds its loss
and gradients to captionax's unsharded step (``jax.value_and_grad`` of its
teacher-forced CE) within 1e-5: the loss relative, each gradient leaf of
its largest entry (at least 1e-3).  ``--kind labert`` with ``--pipe 4``,
``--seq 4`` and ``--seq 4 --seq-ring`` holds the loss to the sequential
stack's.  The split tensors' lookups and products equal the whole
tensor's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_apply as j_hypernet_apply
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax.models.layers import embedding as j_embedding
from captionax.train.steps import _tf_ce as j_tf_ce
from captionax_torch.cli import scale_check
from captionax_torch.interop import from_jax_params
from captionax_torch.models.layers import embedding, linear
from captionax_torch.parallel.mesh import (
    ColumnShards,
    RowShards,
    Sharding,
    make_mesh,
    vocab_tp_sharding,
)
from captionax_torch.train.state import make_optimizer
from captionax_torch.train.steps import (
    _value_and_grad,
    make_gru_steps,
    make_hypernet_steps,
    mesh_train_step,
)

torch.set_num_threads(1)
TINY = ["--vocab-size", "64", "--num-features", "16", "--feature-size", "8", "--embed-size", "8",
        "--hidden-size", "8"]
NF, FO, E, H, V, R, T = 16, 8, 8, 8, 64, 49, 12
TOL = 1e-5


def lines(out: str) -> list:
    """The printed lines without their numbers."""
    return [ln.split(":")[0] if ln.startswith(("devices", "train loss")) else ln
            for ln in out.strip().splitlines() if not ln.startswith("first step")]


def test_gru_data4_model2(capsys):
    from captionax.cli.scale_check import main as jmain

    out = scale_check.main(["--virtual", "8", "--kind", "gru", "--mesh-data", "4",
                            "--mesh-model", "2"] + TINY)
    got = capsys.readouterr().out
    assert "scale_check OK" in got and "data4 x model2" in got
    assert "fc sharding: PartitionSpec(None, 'model')" in got
    assert out["grad_share"] <= TOL and abs(out["loss"] - out["ref_loss"]) <= TOL * out["ref_loss"]
    jmain(["--kind", "gru", "--mesh-data", "4", "--mesh-model", "2"] + TINY)
    assert lines(got) == lines(capsys.readouterr().out)


def jax_model(kind: str):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    decoder = jdec.attention_gru_init(k1, NF, FO, E, H, V)
    if kind == "hypernet":
        return {"decoder": decoder, "hn": j_hypernet_init(k2, hyper_emb=E, input_dim=E + FO,
                                                          hidden_dim=H)}
    return decoder


def batch(n_rows: int):
    rs = np.random.RandomState(1)
    caps = rs.randint(1, V, (n_rows, T)).astype(np.int32)
    caps[::3, -4:] = 0  # some pad
    return {"features": rs.randn(n_rows, R, NF).astype(np.float32), "captions": caps}


@pytest.mark.parametrize("kind", ["gru", "hypernet"])
@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 2), (1, 4)])
def test_mesh_step_against_captionax(kind, n_data, n_model):
    jp = jax_model(kind)
    b = batch(2 * n_data)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if kind == "hypernet":
        jb["style_id"] = jnp.asarray(3)

        def jloss(p):
            theta = j_hypernet_apply(p["hn"], j_embedding(p["decoder"]["embed"], jb["style_id"]))
            return j_tf_ce(p["decoder"], jb, 0, gru_params=theta)
    else:
        def jloss(p):
            return j_tf_ce(p, jb, 0)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(jp)
    mesh = make_mesh(n_data, n_model, devices=["cpu"] * 8)
    params = scale_check.place_model_axis(
        from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"), mesh)
    if n_model > 1:
        dec = params["decoder"] if kind == "hypernet" else params
        assert isinstance(dec["fc"]["w"], ColumnShards) and isinstance(dec["embed"], RowShards)
        assert len(dec["fc"]["w"]) == n_model
    tx = make_optimizer(1e-3)
    step = (make_hypernet_steps(tx) if kind == "hypernet" else make_gru_steps(tx))[0]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if kind == "hypernet":
        tb["style_id"] = torch.tensor(3)
    loss, grads = _value_and_grad(lambda p: mesh_train_step(step.loss_fn, tx, mesh).loss_fn(
        p, tb), params)
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    joined = scale_check._joined(grads)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads), "cpu")
    assert scale_check.grad_share(joined, ref) <= TOL


@pytest.mark.parametrize("flags", [["--pipe", "4"], ["--seq", "4"], ["--seq", "4", "--seq-ring"]])
def test_labert(capsys, flags):
    out = scale_check.main(["--virtual", "8", "--kind", "labert", "--hidden", "32",
                            "--bert-layers", "4", "--bert-heads", "2"] + TINY + flags)
    got = capsys.readouterr().out
    assert "scale_check OK" in got and "== sequential" in got
    assert abs(out["loss"] - out["ref_loss"]) <= TOL * out["ref_loss"]
    assert scale_check.grad_share(out["grads"], out["ref_grads"]) <= 1e-4


def test_labert_flags_refused():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        scale_check.main(["--virtual", "8", "--kind", "labert", "--pipe", "2", "--seq", "2"])
    with pytest.raises(SystemExit, match="must divide by --pipe 5"):
        scale_check.main(["--virtual", "8", "--kind", "labert", "--pipe", "5"])
    with pytest.raises(SystemExit, match="needs 16 devices"):
        scale_check.main(["--virtual", "8", "--kind", "gru", "--mesh-data", "8",
                          "--mesh-model", "2"] + TINY)


def test_split_tensors_compute_as_whole():
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    g = torch.Generator().manual_seed(0)
    w, b, table = torch.randn(6, 8, generator=g), torch.randn(8, generator=g), torch.randn(
        12, 5, generator=g)
    cols, rows = vocab_tp_sharding(mesh), Sharding(mesh, 0)
    x = torch.randn(3, 6, generator=g)
    sw = cols.place(w)
    assert sw.shape == w.shape and [tuple(p.shape) for p in sw] == [(6, 2)] * 4
    torch.testing.assert_close(linear({"w": sw, "b": cols.place(b)}, x), x @ w + b)
    ids = torch.tensor([[0, 11, 5], [3, 3, 7]])
    st = rows.place(table)
    assert st.shape == table.shape
    assert torch.equal(embedding(st, ids), table[ids])
    assert torch.equal(embedding(st, torch.tensor(9)), table[9])
    with pytest.raises(ValueError, match="does not divide"):
        cols.place(torch.zeros(3, 6))
