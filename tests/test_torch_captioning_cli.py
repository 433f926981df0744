"""The port's ``train_captioning`` and ``train_lstm`` CLIs on the CPU
(``--device cpu``) against captionax's, at the committed fixture's sizes
(E = H = 16, 12 synthetic images, batches of 4, ``--max-len 10``), two
epochs, every step logged.

The seams (as in ``test_torch_cc_cli.py``):
- captionax's initial model is carried into the port
  (``build_capgru_model``; for ``train_lstm``, the tree captionax hands to
  ``create_train_state`` replaces the port's ``build_lstm_model`` result);
- both packages encode with one host function of the uint8 images
  (:func:`stub_regions`) in place of the ResNet: captionax's jitted
  encoders reach it through ``jax.pure_callback``, the port's through
  ``make_encoder``, so the features are the same numbers;
- ``train_captioning``'s per-step draws are captionax's: step s's h0 is
  ``uniform(fold_in(PRNGKey(s), 0), (B, H))`` (GRU) and its sampled
  tokens' noise ``gumbel(split(PRNGKey(s), T)[t], (B, V))``, given to the
  port through its ``step_draws``.

Under them: every logged loss within 1e-5 relative, the logged
teacher-forcing probability equal (the numpy binomial schedule, with
``--tf-decay 0.5``: teacher-forced and sampled steps both run), ``fc_out``
bit-equal to its init without ``--train-fc-out`` (and moved with it);
``train_lstm``'s validation loss within 1e-5 relative and its metrics
within 1e-6, and its checkpoint restoring the final parameters exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.cli import train_captioning as jcap
from captionax.cli import train_lstm as jlstm
from captionax_torch.cli import train_captioning as tcap
from captionax_torch.cli import train_lstm as tlstm
from captionax_torch.interop import from_jax_params
from captionax_torch.train import checkpoint as tckpt
from captionax_torch.train.state import tree_leaves
from tests.fixtures.gru_fixture import flags

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
LOSS_RTOL = 1e-5
METRIC_TOL = 1e-6
PROJECTION = np.random.RandomState(0).randn(3, 2048).astype(np.float32)


def stub_regions(images) -> np.ndarray:
    """uint8 [B, H, W, 3] -> f32 [B, 49, 2048]: each cell of a 7x7 grid's
    mean colour through a fixed projection."""
    x = np.asarray(images, np.float32)
    b, h, w, _ = x.shape
    x = x[:, :h // 7 * 7, :w // 7 * 7].reshape(b, 7, h // 7, 7, w // 7, 3)
    return np.abs(x.mean(axis=(2, 4)).reshape(b, 49, 3) / 255.0 @ PROJECTION).astype(np.float32)


def stub_global(images) -> np.ndarray:
    return stub_regions(images).mean(axis=1)


def jax_stub(fn, shape_of):
    """A jit-able function of the images computing ``fn`` on the host."""
    def call(_params, images):
        shape = shape_of(images.shape[0])
        return jax.pure_callback(lambda x: fn(x).reshape(shape),
                                 jax.ShapeDtypeStruct(shape, jnp.float32), images)
    return call


def stub_encoders(mp, jmod, tmod):
    mp.setattr(jmod, "build_encoder", lambda *a, **k: {})
    mp.setattr(jmod, "preprocess_images", lambda images: images)
    mp.setattr(jmod, "resnet_apply", jax_stub(stub_global, lambda b: (b, 1, 1, 2048)))
    if hasattr(jmod, "encoder_cnn"):
        mp.setattr(jmod, "encoder_cnn", jax_stub(stub_regions, lambda b: (b, 49, 2048)))
    mp.setattr(tmod, "build_encoder", lambda *a, **k: {})

    def make_encoder(_params, regions=True, device=None):
        fn = stub_regions if regions else stub_global
        return lambda images: torch.from_numpy(fn(np.asarray(images.cpu())))

    mp.setattr(tmod, "make_encoder", make_encoder)


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_both(tmp, jmain, tmain, argv):
    """captionax's main, then the port's with ``--device cpu``, each in its
    own checkpoint dir -> {package: (return value, logged rows, dir)}."""
    out = {}
    for name, main, extra in (("captionax", jmain, []), ("port", tmain, CPU)):
        d = str(tmp / name)
        res = main(flags(d) + argv + extra)
        out[name] = (res, read_log(os.path.join(d, "run.jsonl")), d)
    return out


def assert_losses_agree(runs, keys=("train_loss",)):
    ref, got = runs["captionax"][1], runs["port"][1]
    rows = [r for r in ref if "train_loss" in r]
    assert len([r for r in got if "train_loss" in r]) == len(rows) > 0
    for a, b in zip([r for r in got if "train_loss" in r], rows):
        assert a["step"] == b["step"] and a.get("epoch") == b.get("epoch")
        for k in keys:
            assert abs(a[k] - b[k]) <= LOSS_RTOL * abs(b[k]), (b["step"], k, a[k], b[k])
    return rows


# -------------------------------------------------------- train_captioning
def captionax_step_draws(seed, step, shape, cell, teacher_forcing, device=None):
    """captionax's draws for step ``step`` (its key is ``PRNGKey(step)``)."""
    del seed
    B, T, H, V = shape
    key = jax.random.PRNGKey(step)
    h0 = (torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 0), (B, H))))
          if cell == "gru" else None)
    gumbel = None
    if not teacher_forcing:
        keys = jax.random.split(key, T)
        gumbel = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
            keys[t], (B, V), jnp.float32)) for t in range(T)]))
    return h0, gumbel


CAPTIONING = {
    "gru": ["--cell", "gru"],
    "lstm": ["--cell", "lstm"],
    "gru 2 layers": ["--cell", "gru", "--num-layers", "2"],
    "lstm 2 layers": ["--cell", "lstm", "--num-layers", "2"],
    "train fc_out": ["--cell", "gru", "--train-fc-out"],
    "masked loss": ["--cell", "lstm", "--masked-loss"],
}


@pytest.mark.parametrize("case", list(CAPTIONING))
def test_train_captioning_matches(tmp_path, case):
    made = {}
    real_build = tcap.build_capgru_model

    def jbuild(*args, **kwargs):
        out = jcap_build(*args, **kwargs)
        made["initial"] = jax.tree_util.tree_map(np.asarray, out)
        return out

    def tbuild(*args, **kwargs):
        own = real_build(*args, **kwargs)
        carried = from_jax_params(made["initial"], "cpu")
        assert [tuple(x.shape) for x in tree_leaves(own)] == [
            tuple(x.shape) for x in tree_leaves(carried)]
        made["fc_out"] = {k: v.clone() for k, v in carried["decoder"]["fc_out"].items()}
        return carried

    forced = []
    real_step = tcap.make_train_step

    def make_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def recorded(state, feats, caps, style, teacher_forcing, h0, gumbel):
            forced.append(teacher_forcing)
            return step(state, feats, caps, style, teacher_forcing, h0, gumbel)
        return recorded

    jcap_build = jcap.build_capgru_model
    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jcap, tcap)
        mp.setattr(jcap, "build_capgru_model", jbuild)
        mp.setattr(tcap, "build_capgru_model", tbuild)
        mp.setattr(tcap, "step_draws", captionax_step_draws)
        mp.setattr(tcap, "make_train_step", make_step)
        runs = run_both(tmp_path, jcap.main, tcap.main,
                        CAPTIONING[case] + ["--max-epochs", "2", "--log-every", "1",
                                            "--tf-decay", "0.5"])
    rows = assert_losses_agree(runs, keys=("train_loss", "tf_proba"))
    assert len(rows) == 4
    # the schedule: p = 1, 0.5, then the floor; the first step is teacher-forced
    assert [r["tf_proba"] for r in rows] == [0.5, 0.25, 0.25, 0.25]
    assert forced == schedule(4)  # teacher-forced, then sampled steps
    fc = runs["port"][0].params["decoder"]["fc_out"]
    same = all(torch.equal(fc[k], made["fc_out"][k]) for k in fc)
    assert same != (case == "train fc_out")
    jfc = runs["captionax"][0].params["decoder"]["fc_out"]
    for k in fc:
        np.testing.assert_allclose(fc[k].numpy(), np.asarray(jfc[k]), rtol=1e-4, atol=1e-6)


def schedule(steps, seed=0, decay=0.5, floor=0.25):
    """captionax's teacher-forcing draws: ``RandomState(seed).binomial(1, p)``
    a step, p <- p * decay while p > floor."""
    rs, p, coins = np.random.RandomState(seed), 1.0, []
    for _ in range(steps):
        coins.append(bool(rs.binomial(1, p)))
        p = p * decay if p > floor else p
    return coins


def test_train_captioning_schedule_samples():
    """At ``--seed 0`` the runs above draw TF, TF, then sampled steps."""
    assert schedule(4) == [True, True, False, False]


def test_step_draws_own_generator():
    """Without captionax's draws the port draws its own: h0 for the GRU
    only, noise for a sampled step only, the same for the same step."""
    shape = (3, 5, 4, 7)
    h0, g = tcap.step_draws(0, 2, shape, "gru", False, "cpu")
    assert h0.shape == (3, 4) and g.shape == (5, 3, 7) and torch.isfinite(g).all()
    h0b, gb = tcap.step_draws(0, 2, shape, "gru", False, "cpu")
    assert torch.equal(h0, h0b) and torch.equal(g, gb)
    assert not torch.equal(tcap.step_draws(0, 3, shape, "gru", True, "cpu")[0], h0)
    assert tcap.step_draws(0, 2, shape, "lstm", True, "cpu") == (None, None)


# -------------------------------------------------------------- train_lstm
@pytest.mark.parametrize("variant", tlstm.VARIANTS)
def test_train_lstm_matches(tmp_path, variant):
    made = {}
    real_j_state, real_t_build = jlstm.create_train_state, tlstm.build_lstm_model

    def jstate(params, tx):
        made["initial"] = jax.tree_util.tree_map(np.asarray, params)
        return real_j_state(params, tx)

    def tbuild(*args, **kwargs):
        own, forward = real_t_build(*args, **kwargs)
        carried = from_jax_params(made["initial"], "cpu")
        assert [tuple(x.shape) for x in tree_leaves(own)] == [
            tuple(x.shape) for x in tree_leaves(carried)]
        return carried, forward

    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jlstm, tlstm)
        mp.setattr(jlstm, "create_train_state", jstate)
        mp.setattr(tlstm, "build_lstm_model", tbuild)
        runs = run_both(tmp_path, jlstm.main, tlstm.main,
                        ["--variant", variant, "--max-epochs", "2", "--log-every", "1",
                         "--cache-features"])
    assert len(assert_losses_agree(runs)) == 4
    (_, ref), (state, got) = runs["captionax"][0], runs["port"][0]
    assert set(got) == set(ref)
    assert ("greedy_bleu1" in got) == (variant in ("attention", "sat"))
    for k in ref:
        tol = LOSS_RTOL * abs(ref[k]) if "loss" in k else METRIC_TOL
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    saved = tckpt.restore_checkpoint(runs["port"][2])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                 tree_leaves(saved)))
    assert tckpt.latest_step(runs["port"][2]) == 4
