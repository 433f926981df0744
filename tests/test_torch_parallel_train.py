"""The port's data-parallel training on the CPU: a gloo world of 2 ranks,
one process each, against captionax's ``jit_data_parallel`` on a 2-device
CPU mesh and against the port's own one-process step on the whole batch.

One world (``parallel.launch``) runs every case of this module in a
module-scoped fixture (``tests/fixtures/parallel_ranks.py``): the gru and
hypernet steps on both recurrence routes (the per-step loop and K3's plain
version), each batch's two halves holding very different numbers of
non-pad tokens; a step whose gradients are NaN on rank 1 alone;
``CaptionTrainer(mesh=...)`` for two epochs, plain and with mixup, each
followed by ``test_beam``.  Weights come from captionax, carried by
``from_jax_params``.  The tolerances are captionax's own for its mesh
tests: the loss within 1e-5 relative, the parameters within 5e-4 after the
steps (tests/test_hypernet_train.py), the harness's epoch losses within
2e-5 relative (tests/test_harness.py).  Every rank hashes its parameters
after every step: the replicas must stay bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.core.config import TrainConfig as JTrainConfig
from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.core.vocab import extract_factual_caption_lines as jextract
from captionax.models import decoder as jdec
from captionax.models import hypernet as jhn
from captionax.parallel.mesh import make_mesh as jmake_mesh
from captionax.parallel.mesh import replicate_params as jreplicate
from captionax.parallel.mesh import shard_batch as jshard_batch
from captionax.train import state as jstate
from captionax.train import steps as jsteps
from captionax.train.harness import CaptionTrainer as JCaptionTrainer
from captionax_torch.cli import train_hypernet
from captionax_torch.core import config as tconfig
from captionax_torch.core.vocab import build_vocab, extract_factual_caption_lines
from captionax_torch.interop import from_jax_params
from captionax_torch.parallel import make_mesh, shard_batch
from captionax_torch.parallel.launch import launch
from captionax_torch.parallel.mesh import shard_bounds
from captionax_torch.train import harness as tharness
from captionax_torch.train import steps as tsteps
from captionax_torch.train.state import create_train_state, make_optimizer, tree_leaves
from tests.fixtures import parallel_ranks
from tests.fixtures.gru_fixture import CAPTIONS, flags

torch.set_num_threads(1)
NF, F, E, H = 24, 16, 16, 16
B, R, T = 8, 9, 10
LR = 1e-3
N_STEPS = 3
LOSS_RTOL = 1e-5          # tests/test_hypernet_train.py:391
PARAM_ATOL = 5e-4         # tests/test_hypernet_train.py:400
VA_BIAS_ATOL = 2 * LR * N_STEPS  # v_a's bias: a zero gradient taken as noise, Adam's step ~lr
EPOCH_RTOL = 2e-5         # tests/test_harness.py:431
CPU = ["--device", "cpu"]
STEP_CASES = [(kind, fused) for kind in ("gru", "hypernet") for fused in (False, True)]


@pytest.fixture(scope="module")
def vocab():
    return build_vocab(extract_factual_caption_lines(CAPTIONS))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(kind, V, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    decoder = jdec.attention_gru_init(k1, NF, F, E, H, V)
    if kind == "gru":
        return np_tree(decoder)
    return np_tree({"decoder": decoder,
                    "hn": jhn.hypernet_init(k2, hyper_emb=E, input_dim=E + F, hidden_dim=H)})


def make_batches(V, n, seed, rows=B):
    """Batches whose first half holds 1-2 words a caption and whose second
    half holds 6-8: the two shards' token counts differ by about 3x."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        caps = np.zeros((rows, T), np.int32)
        for r in range(rows):
            k = rs.randint(1, 3) if r < rows // 2 else rs.randint(6, T - 1)
            caps[r, 0], caps[r, 1:k + 1], caps[r, k + 1] = 1, rs.randint(4, V, k), 2
        out.append({"features": rs.randn(rows, R, NF).astype(np.float32), "captions": caps,
                    "style_id": np.int32((4, 3, 6)[i % 3])})
    return out


def harness_config(tmp, **kw):
    return dict(max_epochs=2, batch_size=B, lr=LR, checkpoint_dir=str(tmp), log_every=100,
                beam_max_steps=6, plateau_patience=0, plateau_cooldown=0, **kw)


def small_probe(V):
    from captionax.models import classifiers as jclf

    return np_tree(jclf.small_style_classifier_init(jax.random.PRNGKey(3), V, 12, 3))


@pytest.fixture(scope="module")
def world(vocab, tmp_path_factory):
    """Every case, run once on a gloo world of 2 ranks; -> (cases, results)."""
    V = len(vocab)
    tmp = tmp_path_factory.mktemp("parallel")
    batches = make_batches(V, N_STEPS, seed=0)
    cases = {f"{kind}-{'fused' if fused else 'loop'}": {
        "kind": kind, "fused": fused, "lr": LR, "params": jax_model(kind, V),
        "batches": batches} for kind, fused in STEP_CASES}
    cases["poisoned"] = dict(cases["gru-loop"], poison=(1, 1))
    # 9 validation rows in batches of 8: the tail batch is one row, so rank 1's
    # shard of it is empty
    val = make_batches(V, 1, seed=99) + make_batches(V, 1, seed=98, rows=1)
    train = [make_batches(V, 3, seed=epoch) for epoch in range(2)]
    cases["harness"] = {"kind": "hypernet", "params": jax_model("hypernet", V), "vocab": vocab,
                        "config": harness_config(tmp / "mesh"), "train": train, "val": val}
    cases["harness-mixup"] = dict(
        cases["harness"], config=harness_config(tmp / "mesh-mixup", mixup=True),
        classifier=small_probe(V))
    return cases, launch(parallel_ranks.train_world, 2, (cases,), device="cpu")


def one_process_steps(case):
    tx = make_optimizer(case["lr"])
    make = tsteps.make_gru_steps if case["kind"] == "gru" else tsteps.make_hypernet_steps
    train, _ = make(tx, fused_scan=case["fused"])
    state = create_train_state(from_jax_params(case["params"], device="cpu"), tx, device="cpu")
    losses = []
    for batch in case["batches"]:
        state, metrics = train(state, batch)
        losses.append(float(metrics["train_loss"]))
    return losses, state.params


def captionax_mesh_steps(case):
    mesh = jmake_mesh(n_data=2)
    tx = jstate.make_optimizer(case["lr"])
    make = jsteps.make_gru_steps if case["kind"] == "gru" else jsteps.make_hypernet_steps
    train, _ = make(tx, fused_scan=case["fused"])
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    state = jstate.create_train_state(jreplicate(mesh, params), tx)
    step = jsteps.jit_data_parallel(train, mesh, case["batches"][0], donate_state=False)
    losses = []
    for batch in case["batches"]:
        state, metrics = step(state, jshard_batch(mesh, batch))
        losses.append(float(metrics["train_loss"]))
    return losses, np_tree(state.params)


def assert_params_close(got, ref):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = tree_leaves(got)
    assert len(ref_flat) == len(got_leaves)
    for (path, b), a in zip(ref_flat, got_leaves):
        name = jax.tree_util.keystr(path)
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        atol = VA_BIAS_ATOL if name.endswith("['v_a']['b']") else PARAM_ATOL
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol, err_msg=name)


def test_world_is_two_gloo_ranks(world):
    _, out = world
    assert out["world"] == {"size": 2, "backend": "gloo", "devices": ["cpu", "cpu"]}


def test_shards_hold_unequal_token_counts(world):
    """The trap the step is built against: each rank's own mean, averaged,
    is not the batch's mean at these counts; the step's loss is the
    batch's."""
    cases, out = world
    case = cases["gru-loop"]
    counts = [[int((b["captions"][a:z] != 0).sum()) for a, z in shard_bounds(B, 2)]
              for b in case["batches"]]
    assert all(hi > 2 * lo for lo, hi in counts), counts
    tb = case["batches"][0]
    params = from_jax_params(case["params"], device="cpu")
    shard_means = [float(tsteps._tf_ce(params, {k: torch.as_tensor(v[a:z]) for k, v in tb.items()
                                                  if k != "style_id"}, 0))
                   for a, z in shard_bounds(B, 2)]
    whole = float(tsteps._tf_ce(params, {k: torch.as_tensor(v) for k, v in tb.items()
                                         if k != "style_id"}, 0))
    assert abs(np.mean(shard_means) - whole) > 100 * LOSS_RTOL * whole
    assert out["gru-loop"]["losses"][0] == pytest.approx(whole, rel=LOSS_RTOL)


@pytest.mark.parametrize("name", [f"{k}-{'fused' if f else 'loop'}" for k, f in STEP_CASES])
def test_step_matches_captionax_mesh(world, name):
    cases, out = world
    ref_losses, ref_params = captionax_mesh_steps(cases[name])
    np.testing.assert_allclose(out[name]["losses"], ref_losses, rtol=LOSS_RTOL)
    assert_params_close(from_jax_params(out[name]["params"], device="cpu"), ref_params)


@pytest.mark.parametrize("name", [f"{k}-{'fused' if f else 'loop'}" for k, f in STEP_CASES])
def test_step_matches_one_process(world, name):
    cases, out = world
    losses, params = one_process_steps(cases[name])
    np.testing.assert_allclose(out[name]["losses"], losses, rtol=LOSS_RTOL)
    assert_params_close(params, out[name]["params"])


@pytest.mark.parametrize("name", [f"{k}-{'fused' if f else 'loop'}" for k, f in STEP_CASES]
                         + ["poisoned", "harness", "harness-mixup"])
def test_replicas_stay_bit_equal(world, name):
    digests = world[1][name]["digests"]
    for per_rank in (digests if isinstance(digests[0], list) else [digests]):
        assert len(per_rank) == 2 and per_rank[0] == per_rank[1]


def test_nonfinite_gradient_on_one_rank_skips_on_both(world):
    """Rank 1's features hold a NaN at step 2: the reduced gradient is not
    finite on either rank, both drop the step (Adam's count stays at 2 of 3
    steps) and the replicas stay equal."""
    _, out = world
    got = out["poisoned"]
    assert np.isnan(got["losses"][1]) and np.isfinite(got["losses"][2])
    assert got["skipped"] == 1 and got["adam_count"] == N_STEPS - 1
    assert got["losses"][0] == out["gru-loop"]["losses"][0]


def single_trainer(case, tmp, classifier=None):
    cfg = tconfig.TrainConfig(**dict(case["config"], checkpoint_dir=str(tmp)))
    trainer = tharness.CaptionTrainer(
        from_jax_params(case["params"], device="cpu"), case["kind"], cfg, case["vocab"],
        run_name="run", device="cpu",
        style_classifier_params=None if classifier is None
        else from_jax_params(classifier, device="cpu"))
    hist = trainer.fit(lambda epoch: case["train"][epoch], lambda: case["val"])
    return trainer, hist


@pytest.mark.parametrize("name", ("harness", "harness-mixup"))
def test_harness_matches_one_device(world, tmp_path, name):
    cases, out = world
    case = cases[name]
    trainer, hist = single_trainer(case, tmp_path, case.get("classifier"))
    got = out[name]["history"]
    for epoch in (0, 1):
        for key in ("train_loss_epoch", "val_loss_tf", "val_loss"):
            np.testing.assert_allclose(got[epoch][key], hist[epoch][key], rtol=EPOCH_RTOL,
                                       err_msg=f"{key} {epoch}")
        for key in ("val_bleu1", "val_cider"):
            assert got[epoch][key] == pytest.approx(hist[epoch][key], abs=1e-6)
    beam = trainer.test_beam(case["val"])
    assert set(out[name]["beam"]) == set(beam)
    for key, v in beam.items():
        assert out[name]["beam"][key] == pytest.approx(v, rel=1e-6, abs=1e-9), key


def test_harness_matches_captionax_mesh(world, tmp_path):
    """captionax's CaptionTrainer on a 2-device mesh from the same weights."""
    cases, out = world
    case = cases["harness"]
    cfg = JTrainConfig(**dict(case["config"], checkpoint_dir=str(tmp_path)))
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    jvocab = jbuild_vocab(jextract(CAPTIONS))
    trainer = JCaptionTrainer(params, "hypernet", cfg, jvocab, mesh=jmake_mesh(n_data=2),
                              run_name="run")
    hist = trainer.fit(lambda epoch: case["train"][epoch], lambda: case["val"])
    got = out["harness"]["history"]
    for epoch in (0, 1):
        for key in ("train_loss_epoch", "val_loss_tf", "val_loss"):
            np.testing.assert_allclose(got[epoch][key], hist[epoch][key], rtol=EPOCH_RTOL,
                                       err_msg=f"{key} {epoch}")


def test_rank0_alone_writes(world):
    """One checkpoint and one log, rank 0's: the log has the single-device
    run's rows, not twice as many."""
    cases, _ = world
    ckdir = cases["harness"]["config"]["checkpoint_dir"]
    steps = [d for d in os.listdir(ckdir) if d.isdigit()]
    assert len(steps) == 1
    with open(os.path.join(ckdir, "run.jsonl")) as f:
        rows = [line for line in f if '"epoch_seconds"' in line]
    assert len(rows) == 2


def test_train_hypernet_mesh_data_2_matches_0(tmp_path):
    """The CLI starts its own 2 ranks and returns rank 0's history."""
    extra = CPU + ["--max-epochs", "1", "--cache-features"]
    one = train_hypernet.main(flags(str(tmp_path / "one")) + extra)
    two_dir = str(tmp_path / "two")
    two = train_hypernet.main(flags(two_dir) + extra + ["--mesh-data", "2"])
    for key in ("train_loss_epoch", "val_loss_tf", "val_loss"):
        np.testing.assert_allclose(two[0][key], one[0][key], rtol=EPOCH_RTOL, err_msg=key)
    assert len([d for d in os.listdir(two_dir) if d.isdigit()]) == 1


def test_launch_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed first.*rank 1 fails"):
        launch(parallel_ranks.fail_on_rank_1, 2, device="cpu")


def test_one_process_mesh_refuses_a_train_step():
    mesh = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="one process per rank"):
        tsteps.jit_data_parallel(lambda s, b: (s, {}), mesh)


def test_shard_batch_splits_rows_in_order():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu", "cpu"])
    batch = {"captions": np.arange(8 * 3).reshape(8, 3), "style_id": np.int32(4)}
    parts = shard_batch(mesh, batch)
    assert [p["captions"][:, 0].tolist() for p in parts] == [[0, 3], [6, 9], [12, 15], [18, 21]]
    assert all(int(p["style_id"]) == 4 for p in parts)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh, {"captions": np.zeros((6, 3))})
    assert shard_bounds(9, 2, even=False) == [(0, 5), (5, 9)]
    assert shard_bounds(1, 2, even=False) == [(0, 1), (1, 1)]
