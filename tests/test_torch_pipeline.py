"""The port's pipeline schedule (captionax_torch/parallel/pipeline.py) on
the CPU against captionax's GPipe schedule over its virtual 8-device CPU
mesh, every case of tests/test_pipeline.py: forward at (pipe, micro) =
(4, 4), (8, 2), (2, 8), with the attention-mask extra, on a data x pipe
mesh, through the gradient (the port's autograd through its device moves
against ``jax.grad`` through ``ppermute``), LaBERT's encoder hook and both
CATR stacks.  Same weights (captionax's init carried with
``from_jax_params``), same inputs; atol 1e-5.  The port's mesh holds CPU
slots (a mesh's devices may repeat)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import transformer as jtr
from captionax.parallel import pipeline as jpipe
from captionax_torch.interop import from_jax_params
from captionax_torch.models import transformer as ttr
from captionax_torch.parallel import pipeline as tpipe
from captionax_torch.train.state import tree_leaves
from captionax_torch.train.steps import _value_and_grad

torch.set_num_threads(1)
HEADS, DIM, FF, L, B, T = 4, 32, 64, 8, 8, 6
ATOL = 1e-5
CPU8 = ["cpu"] * 8


def port_mesh(n_pipe, n_data=1):
    return tpipe.pipeline_mesh(n_pipe, n_data, devices=CPU8)


def T_(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol)


@pytest.fixture(scope="module")
def stacked():
    layers = jtr.bert_encoder_init(jax.random.PRNGKey(0), L, DIM, HEADS, FF)
    jst = jpipe.stack_layers(layers)
    return jst, from_jax_params(jax.tree_util.tree_map(np.asarray, jst), "cpu")


@pytest.fixture(scope="module")
def x():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, T, DIM)))


def jlayer(p, h, mask=None):
    return jtr.bert_layer(p, h, HEADS, mask)


def tlayer(p, h, mask=None):
    return ttr.bert_layer(p, h, HEADS, mask)


def test_stack_roundtrip(stacked):
    _, tst = stacked
    layers = tpipe.unstack_layers(tst)
    assert len(layers) == L
    again = tpipe.stack_layers(layers)
    for a, b in zip(tree_leaves(tst), tree_leaves(again)):
        assert torch.equal(a, b)


def test_split_stages_rejects_uneven(stacked):
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.split_stages(stacked[1], 3)
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.make_pipeline(tlayer, port_mesh(3), 2)(stacked[1], T_(np.zeros((B, T, DIM),
                                                                              np.float32)))


def test_sequential_matches_loop(stacked, x):
    jst, tst = stacked
    ref = jpipe.sequential_apply(jlayer, jst, jnp.asarray(x))
    close(tpipe.sequential_apply(tlayer, tst, T_(x)), ref)


@pytest.mark.parametrize("n_pipe,n_micro", [(4, 4), (8, 2), (2, 8)])
def test_pipeline_matches_sequential(stacked, x, n_pipe, n_micro):
    jst, tst = stacked
    ref = jpipe.make_pipeline(jlayer, jpipe.pipeline_mesh(n_pipe), n_micro)(jst, jnp.asarray(x))
    got = tpipe.make_pipeline(tlayer, port_mesh(n_pipe), n_micro)(tst, T_(x))
    close(got, ref)
    close(got, jpipe.sequential_apply(jlayer, jst, jnp.asarray(x)))


def test_pipeline_with_mask_extra(stacked, x):
    jst, tst = stacked
    lengths = np.asarray([T, T - 1, T - 2, 3, T, 2, T - 3, 1])
    keep = np.arange(T)[None, :] < lengths[:, None]
    mask = np.where(keep[:, None, None, :], 0.0, -1e9).astype(np.float32)
    mask = np.ascontiguousarray(np.broadcast_to(mask, (B, 1, T, T)))
    ref = jpipe.make_pipeline(jlayer, jpipe.pipeline_mesh(4), n_micro=4)(
        jst, jnp.asarray(x), jnp.asarray(mask))
    got = tpipe.make_pipeline(tlayer, port_mesh(4), n_micro=4)(tst, T_(x), T_(mask))
    close(got, ref)


def test_pipeline_composes_with_data_parallel(stacked, x):
    jst, tst = stacked
    ref = jpipe.make_pipeline(jlayer, jpipe.pipeline_mesh(n_pipe=4, n_data=2), n_micro=2,
                              data_axis="data")(jst, jnp.asarray(x))
    got = tpipe.make_pipeline(tlayer, port_mesh(4, 2), n_micro=2, data_axis="data")(tst, T_(x))
    close(got, ref)


@pytest.mark.parametrize("n_data", [1, 2])
def test_pipeline_grad_matches_sequential(stacked, x, n_data):
    """The port's gradient through its moves against ``jax.grad`` of
    captionax's schedule; on data x pipe every data row's copy of a stage's
    weights sends its gradient back to the one leaf."""
    jst, tst = stacked
    tgt = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, T, DIM)))
    data = "data" if n_data > 1 else None
    jf = jpipe.make_pipeline(jlayer, jpipe.pipeline_mesh(4, n_data), n_micro=4 // n_data,
                             data_axis=data)
    tf = tpipe.make_pipeline(tlayer, port_mesh(4, n_data), n_micro=4 // n_data, data_axis=data)
    g_ref = jax.grad(lambda p: jnp.mean((jf(p, jnp.asarray(x)) - tgt) ** 2))(jst)
    _, g = _value_and_grad(lambda p: torch.mean((tf(p, T_(x)) - T_(tgt)) ** 2), tst)
    _, g_seq = _value_and_grad(
        lambda p: torch.mean((tpipe.sequential_apply(tlayer, p, T_(x)) - T_(tgt)) ** 2), tst)
    for a, b, c in zip(tree_leaves(g), jax.tree_util.tree_leaves(g_ref), tree_leaves(g_seq)):
        close(a, b)
        close(a, c.numpy())


def test_pipeline_rejects_bad_microbatch(stacked, x):
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.make_pipeline(tlayer, port_mesh(4), n_micro=3)(stacked[1], T_(x))


def test_labert_pipelined_encoder_matches():
    """The encoder_fn hook: LaBERT's stack (8 layers here) as a 4-stage
    pipeline, against captionax's pipelined and sequential forward."""
    from captionax.models import labert as jlab
    from captionax_torch.models import labert as tlab

    params = jlab.labert_init(jax.random.PRNGKey(3), vocab_size=64, hidden=32, num_layers=8,
                              num_heads=4, intermediate=64, max_position=32, num_regions=4,
                              image_dim=16)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
    Bq, Tt = 8, 6
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (Bq, 4, 16)))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (Bq, Tt), 0, 64))
    types = np.zeros((Bq, Tt), np.int32)
    amask = np.ones((Bq, Tt), np.float32)
    ref = jlab.labert_forward(params, feats, ids, types, amask, num_heads=4)
    jenc = jpipe.pipelined_bert_encoder(jpipe.pipeline_mesh(4), n_micro=4, num_heads=4)
    jout = jlab.labert_forward(params, feats, ids, types, amask, num_heads=4, encoder_fn=jenc)
    enc = tpipe.pipelined_bert_encoder(port_mesh(4), n_micro=4, num_heads=4)
    got = tlab.labert_forward(tp, T_(feats), T_(ids).long(), T_(types).long(), T_(amask),
                              num_heads=4, encoder_fn=enc)
    close(got, jout)
    close(got, ref)


def test_catr_forward_pipelined_stacks_match():
    """Both CATR halves (4 + 4 layers here) as pipelines through the
    catr_forward hooks."""
    from captionax.models import catr as jcatr
    from captionax_torch.models import catr as tcatr

    params = jcatr.catr_init(jax.random.PRNGKey(8), vocab_size=64, hidden=32, num_heads=4,
                             ff=64, enc_layers=4, dec_layers=4, image_dim=16)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
    Bq, Tt = 8, 6
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (Bq, 6, 16)))
    caps = np.asarray(jax.random.randint(jax.random.PRNGKey(10), (Bq, Tt), 0, 64))
    ref = jcatr.catr_forward(params, feats, caps, grid_hw=(2, 3), num_heads=4)
    jenc, jdec = jpipe.pipelined_catr_stacks(jpipe.pipeline_mesh(4), n_micro=4, num_heads=4)
    jout = jcatr.catr_forward(params, feats, caps, grid_hw=(2, 3), encoder_fn=jenc,
                              decoder_fn=jdec, num_heads=4)
    enc, dec = tpipe.pipelined_catr_stacks(port_mesh(4), n_micro=4, num_heads=4)
    got = tcatr.catr_forward(tp, T_(feats), T_(caps).long(), grid_hw=(2, 3), encoder_fn=enc,
                             decoder_fn=dec, num_heads=4)
    close(got, jout)
    close(got, ref)


def test_catr_encoder_stack_pipelines_via_extras():
    """The DETR encoder layer's per-position embedding rides the schedule
    as an extra (broadcast over the batch)."""
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    layers = [jtr.detr_encoder_layer_init(k, DIM, HEADS, FF) for k in keys]
    tlayers = from_jax_params(jax.tree_util.tree_map(np.asarray, layers), "cpu")
    pos = np.asarray(jtr.sine_position_2d(2, 3, DIM))[None]
    xin = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (B, 6, DIM)))
    ref = jnp.asarray(xin)
    for p in layers:
        ref = jtr.detr_encoder_layer(p, ref, pos, HEADS, pre_norm=True)
    pos_b = np.ascontiguousarray(np.broadcast_to(pos, (B, 6, DIM)))
    jout = jpipe.make_pipeline(lambda p, h, q: jtr.detr_encoder_layer(p, h, q, HEADS, True),
                               jpipe.pipeline_mesh(4), n_micro=4)(
        jpipe.stack_layers(layers), jnp.asarray(xin), jnp.asarray(pos_b))
    got = tpipe.make_pipeline(lambda p, h, q: ttr.detr_encoder_layer(p, h, q, HEADS, True),
                              port_mesh(4), n_micro=4)(tlayers, T_(xin), T_(pos_b))
    close(got, jout)
    close(got, ref)


def test_pipeline_mesh_layout():
    mesh = tpipe.pipeline_mesh(4, 2, devices=CPU8)
    assert mesh.shape == {"data": 2, "pipe": 4}
    assert mesh.n_data == 2 and len(mesh.axis_slots("pipe", 1)) == 4
    with pytest.raises(ValueError, match="needs 8 devices"):
        tpipe.pipeline_mesh(4, 2, devices=["cpu"] * 4)
