"""The port's ``train_labert`` and ``train_catr`` CLIs on the CPU
(``--device cpu``) against captionax's, at ``--hidden 32`` with 2 layers
(LaBERT 2 heads, CATR 4 heads) on the committed fixture's 12 synthetic
images in batches of 4, two epochs, every step logged.

The seams (as in ``test_torch_captioning_cli.py``):
- captionax's initial model (the tree its CLI hands to
  ``create_train_state``) replaces the port's ``build_labert_model`` /
  ``build_catr_model`` result, after a check that the shapes agree;
- both packages encode with one host function of the uint8 images
  (``stub_regions``) in place of the ResNet;
- ``train_labert``'s mask draws are captionax's: step s's from
  ``PRNGKey(s)``, every validation batch's from ``PRNGKey(0)``, given to
  the port through its ``step_mask_draws``;
- ``CaptionMetrics`` is wrapped in both packages to record the unrounded
  metrics of the final decode (mask-predict for LaBERT, greedy for CATR).

Under them: every logged train loss and LaBERT's validation losses within
1e-5 relative, the final metrics within 1e-6.  ``--pipe 2``, ``--seq 2``
and ``--seq 2 --seq-ring`` train as the run without them does (the
pipeline and sequence schedules on CPU slots), their bad settings raise
captionax's messages, and ``--mesh-data 2`` is ignored, as in captionax;
an epoch without a train batch raises in both packages (the epoch line
prints the last loss)."""

import jax
import numpy as np
import pytest
import torch

from captionax.cli import train_catr as jcatr
from captionax.cli import train_labert as jlab
from captionax_torch.cli import train_catr as tcatr
from captionax_torch.cli import train_labert as tlab
from captionax_torch.interop import from_jax_params
from captionax_torch.train.state import tree_leaves
from tests.fixtures.gru_fixture import flags
from tests.test_torch_captioning_cli import (
    CPU,
    LOSS_RTOL,
    METRIC_TOL,
    assert_losses_agree,
    jax_stub,
    run_both,
    stub_regions,
)

torch.set_num_threads(1)
LABERT = ["--hidden", "32", "--bert-layers", "2", "--bert-heads", "2"]
CATR = ["--hidden", "32", "--heads", "4", "--enc-layers", "2", "--dec-layers", "2"]
EPOCHS = ["--max-epochs", "2", "--log-every", "1"]
PACKAGES = {"labert": (jlab, tlab, "build_labert_model", LABERT),
            "catr": (jcatr, tcatr, "build_catr_model", CATR)}


def captionax_mask_draws(key, B, T, device=None):
    """captionax's mask draws from ``PRNGKey(key)``: (ratio, scores)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    ratio = jax.random.uniform(k1, (B, 1), minval=0.1, maxval=1.0)
    scores = jax.random.uniform(k2, (B, T))
    return torch.from_numpy(np.array(ratio)), torch.from_numpy(np.array(scores))


def stubbed(mp, jmod, tmod, build_name, made):
    """The seams above on ``mp``; ``made`` collects the initial tree and
    each package's computed metrics."""
    mp.setattr(jmod, "build_encoder", lambda *a, **k: {})
    mp.setattr(jmod, "preprocess_images", lambda images: images)
    mp.setattr(jmod, "encoder_cnn", jax_stub(stub_regions, lambda b: (b, 49, 2048)))
    mp.setattr(tmod, "build_encoder", lambda *a, **k: {})
    mp.setattr(tmod, "make_encoder", lambda _p, regions=True, device=None: (
        lambda images: torch.from_numpy(stub_regions(np.asarray(images.cpu())))))

    real_state, real_build = jmod.create_train_state, getattr(tmod, build_name)

    def jstate(params, tx):
        made["initial"] = jax.tree_util.tree_map(np.asarray, params)
        return real_state(params, tx)

    def tbuild(*args, **kwargs):
        own = real_build(*args, **kwargs)
        carried = from_jax_params(made["initial"], "cpu")
        assert [tuple(x.shape) for x in tree_leaves(own)] == [
            tuple(x.shape) for x in tree_leaves(carried)]
        return carried

    mp.setattr(jmod, "create_train_state", jstate)
    mp.setattr(tmod, build_name, tbuild)
    for name, mod in (("captionax", jmod), ("port", tmod)):
        class Recorded(mod.CaptionMetrics):
            def compute(self, _name=name):
                out = super().compute()
                made.setdefault(f"metrics_{_name}", []).append(out)
                return out
        mp.setattr(mod, "CaptionMetrics", Recorded)
    if tmod is tlab:
        mp.setattr(tlab, "step_mask_draws", captionax_mask_draws)


@pytest.fixture(scope="module", params=list(PACKAGES))
def runs(request, tmp_path_factory):
    jmod, tmod, build_name, sizes = PACKAGES[request.param]
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        stubbed(mp, jmod, tmod, build_name, made)
        out = run_both(tmp_path_factory.mktemp(request.param), jmod.main, tmod.main,
                       sizes + EPOCHS)
    return request.param, out, made


def test_train_losses(runs):
    _, out, _ = runs
    assert len(assert_losses_agree(out)) == 4  # 9 train images: 2 steps an epoch


def test_validation_losses(runs):
    name, out, _ = runs
    ref = [r for r in out["captionax"][1] if "val_loss" in r]
    got = [r for r in out["port"][1] if "val_loss" in r]
    assert len(got) == len(ref) == (2 if name == "labert" else 0)
    for a, b in zip(got, ref):
        assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
        assert abs(a["val_loss"] - b["val_loss"]) <= LOSS_RTOL * abs(b["val_loss"])


def test_final_metrics(runs):
    name, out, made = runs
    ref, got = made["metrics_captionax"], made["metrics_port"]
    assert len(got) == len(ref) == 1
    assert set(got[0]) == set(ref[0])
    for k in ref[0]:
        assert abs(got[0][k] - ref[0][k]) <= METRIC_TOL, (k, got[0][k], ref[0][k])
    if name == "catr":  # the logged row: the metrics rounded as captionax rounds them
        row = [r for r in out["port"][1] if "val_greedy_bleu1" in r]
        assert len(row) == 1
        for k, v in got[0].items():
            assert row[0][f"val_greedy_{k}"] == round(v, 4)


PARALLEL = [("labert", "--pipe"), ("labert", "--seq"), ("labert", "--mesh-data"),
            ("catr", "--pipe"), ("catr", "--mesh-data"), ("labert", "--seq-ring")]
FLAGS = {"--pipe": ["--pipe", "2"], "--seq": ["--seq", "2"], "--mesh-data": ["--mesh-data", "2"],
         "--seq-ring": ["--seq", "2", "--seq-ring"]}
# (flags, the message of parser.error) for each flag's bad settings; the
# batch is 4, LaBERT and CATR have 2 layers a side
BAD = {
    ("labert", "--pipe"): [(["--pipe", "3"], "--bert-layers 2 must divide by --pipe 3"),
                           (["--pipe", "2", "--pipe-micro", "3"],
                            "--batch-size 4 must divide by --pipe-micro 3")],
    ("labert", "--seq"): [(["--seq", "2", "--pipe", "2"],
                           "--seq and --pipe are mutually exclusive")],
    ("labert", "--seq-ring"): [(["--seq", "2", "--seq-ring", "--pipe", "2"],
                                "--seq and --pipe are mutually exclusive")],
    ("catr", "--pipe"): [(["--pipe", "3"], "--enc-layers 2 must divide by --pipe 3"),
                         (["--pipe", "2", "--pipe-micro", "3"],
                          "--batch-size 4 must divide by --pipe-micro 3")],
}
PARAM_RTOL = 1e-5   # the logged train losses
GRAD_SHARE = 1e-5   # the first step's gradients, of each leaf's largest entry
FINAL_RTOL = 1e-4   # the final parameters (see test_parallel_flags_raise)
STEPS = 2  # one epoch of 9 train images in batches of 4
LR = 5e-3  # TrainConfig's


def key_bias(path: str) -> bool:
    """An attention key projection's bias: its gradient is 0 up to float
    noise (softmax ignores a shift shared by every key), and Adam scales
    noise into steps of up to ``lr`` whichever its sign."""
    return path.endswith("/k/b")


def leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.fixture(scope="module")
def without_flag():
    """The runs without a parallel flag, one a model, filled by the first
    test that needs each: (final state, first gradients, logged losses)."""
    return {}


def cpu_run(tmod, argv):
    """``tmod.main(argv)`` on the stub encoder; -> (final state, the first
    train step's gradients, copied before the optimizer overwrites them)."""
    first = []
    real = tmod._value_and_grad

    def spy(fn, params):
        loss, grads = real(fn, params)
        if not first:
            first.append([g.clone() for g in tree_leaves(grads)])
        return loss, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmod, "build_encoder", lambda *a, **k: {})
        mp.setattr(tmod, "make_encoder", lambda _p, regions=True, device=None: (
            lambda images: torch.from_numpy(stub_regions(np.asarray(images.cpu())))))
        mp.setattr(tmod, "_value_and_grad", spy)
        return tmod.main(argv), (first or [None])[0]


@pytest.mark.parametrize("name,flag", PARALLEL)
def test_parallel_flags_raise(tmp_path, capsys, without_flag, name, flag):
    """Each parallel flag at 2 trains an epoch on the CPU as the run without
    it does: its first step's gradients within 1e-5 of each leaf's largest
    entry (a key bias's, 0 up to float noise as softmax ignores a shift
    shared by every key, within 1e-5 of the largest gradient), every logged
    train loss within 1e-5 relative, and every final parameter leaf within
    1e-4 relative (the norm of the difference over the leaf's): Adam divides
    each gradient entry by its own root mean square, so an entry that is
    float noise near 0 on both runs moves by up to lr either way (a key
    bias, all such noise, within 2 * lr an entry a step).
    ``--mesh-data`` is ignored, as in captionax: the final state is
    bit-equal.  The flags' bad settings raise captionax's messages through
    ``parser.error``."""
    _, tmod, _, sizes = PACKAGES[name]
    base = sizes + CPU + ["--max-epochs", "1", "--log-every", "1"]
    for bad, message in BAD.get((name, flag), []):
        with pytest.raises(SystemExit):
            cpu_run(tmod, flags(str(tmp_path / "bad")) + base + bad)
        assert message in capsys.readouterr().err
    if name not in without_flag:
        run = cpu_run(tmod, flags(str(tmp_path / "one")) + base)
        without_flag[name] = run + (logged_losses(tmp_path / "one"),)
    want, want_grads, want_losses = without_flag[name]
    got, got_grads = cpu_run(tmod, flags(str(tmp_path / "two")) + base + FLAGS[flag])
    got_losses = logged_losses(tmp_path / "two")
    if flag == "--mesh-data":
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.params),
                                                     tree_leaves(want.params)))
        return
    assert len(got_losses) == len(want_losses) == STEPS
    for a, b in zip(got_losses, want_losses):
        assert abs(a - b) <= PARAM_RTOL * abs(b), (a, b)
    top = max(g.abs().max().item() for g in want_grads)
    paths = leaf_paths(want.params)
    for path, a, b in zip(paths, got_grads, want_grads):
        err = (a - b).abs().max().item()
        bound = GRAD_SHARE * (top if key_bias(path) else b.abs().max().item())
        assert err <= bound, ("gradient", path, err, bound)
    for path, a, b in zip(paths, tree_leaves(got.params), tree_leaves(want.params)):
        if key_bias(path):
            assert (a - b).abs().max().item() <= 2 * STEPS * LR, path
        else:
            rel = ((a - b).norm() / b.norm()).item()
            assert rel <= FINAL_RTOL, (path, rel)


def logged_losses(ckdir):
    import json

    with open(ckdir / "run.jsonl") as f:
        return [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]


def test_resolve_mesh_refuses_pipe_and_seq():
    """--mesh-data does not combine with --pipe or --seq (captionax runs no
    data-parallel mesh beside them); either alone resolves."""
    from argparse import Namespace

    from captionax_torch.cli.common import resolve_mesh

    for extra in ({"pipe": 2}, {"seq": 2}):
        with pytest.raises(ValueError, match="does not combine"):
            resolve_mesh(Namespace(mesh_data=2, device="cpu", **extra))
        assert resolve_mesh(Namespace(mesh_data=0, device="cpu", **extra)) is None
    assert resolve_mesh(Namespace(mesh_data=2, device="cpu", pipe=1, seq=1)).n_data == 2


@pytest.mark.parametrize("name", list(PACKAGES))
def test_epoch_without_a_train_batch_raises(tmp_path, name):
    """9 train images, batches of 16: no train batch, and the epoch line's
    ``float(loss)`` raises in both packages."""
    jmod, tmod, build_name, sizes = PACKAGES[name]
    with pytest.MonkeyPatch.context() as mp:
        stubbed(mp, jmod, tmod, build_name, {})
        for main, extra in ((jmod.main, []), (tmod.main, CPU)):
            with pytest.raises(UnboundLocalError):
                main(flags(str(tmp_path)) + sizes + ["--max-epochs", "1", "--batch-size", "16"]
                     + extra)
