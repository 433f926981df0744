"""The port's style-loss steps (make_hypernet_mixup_steps and
make_hypernet_styleaux_steps in captionax_torch/train/steps.py) on the CPU
against captionax's, on the same weights (carried with from_jax_params),
the same numpy batch and the same draws.

captionax draws ``coeff`` and ``missing`` inside its train step from
``jax.random.split(rng, 3)``; the tests recompute them from the same rng
and hand them to the port's step.  The reference losses are captionax's
loss bodies written out on captionax's own functions (``_tf_logits``,
``hypernet_apply``, ``classifier_soft_apply_fn``, ``mixup_style_target``)
under ``jax.value_and_grad``; the train-step tests then hold the port's
step to captionax's own ``train_step``.

The references run under ``jax.jit``, one compile for each probe kind and
style table (``missing`` and the draws are traced arguments).

Tolerances (f32): the losses within rtol 1e-5; each gradient within
tests/test_torch_train.py's bound (rtol 2e-4, atol max(2e-5 * its largest
entry, 1e-6)).  The free run's fed-back words must be equal first: the
gradients are compared on the same path.  The port has one step where
captionax has two (``split=True`` takes the gradient in two backward
passes, a way round its compiler); the train-step test holds the port's
step to captionax's on both settings."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import classifiers as jclf
from captionax.models import decoder as jdec
from captionax.models import hypernet as jhn
from captionax.train import losses as jlosses
from captionax.train import state as jstate
from captionax.train import steps as jsteps
from captionax_torch.interop import from_jax_params
from captionax_torch.train import state as tstate
from captionax_torch.train import steps as tsteps

torch.set_num_threads(1)
NF, F, E, H, V = 32, 16, 16, 16, 40
B, R, T = 6, 9, 6
CLF_HIDDEN, CLF_LAYERS = 32, 2
VOCAB_IDS, DEDICATED_IDS = (4, 3, 6), (0, 1, 2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def model(table: str):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"decoder": jdec.attention_gru_init(k1, NF, F, E, H, V),
              "hn": jhn.hypernet_init(k2, hyper_emb=E, input_dim=E + F, hidden_dim=H)}
    if table == "dedicated":
        params["style_embed"] = jax.random.normal(k3, (3, E))
    return np_tree(params)


def probe(kind: str):
    key = jax.random.PRNGKey(7)
    if kind == "small":
        return np_tree(jclf.small_style_classifier_init(key, V, 12, 3))
    return np_tree(jclf.style_classifier_init(key, V, 3, CLF_HIDDEN, CLF_LAYERS))


def make_batch(seed, style_id):
    rs = np.random.RandomState(seed)
    caps = rs.randint(1, V, (B, T)).astype(np.int32)
    caps[:2, -2:] = 0
    return {"features": rs.randn(B, R, NF).astype(np.float32), "captions": caps,
            "style_id": np.asarray(style_id, np.int32)}


def setup(table):
    ids = VOCAB_IDS if table == "vocab" else DEDICATED_IDS
    embed = (jsteps.style_token_embed, tsteps.style_token_embed) if table == "vocab" else (
        jsteps.dedicated_style_embed, tsteps.dedicated_style_embed)
    return model(table), ids, embed


def captionax_draws(rng):
    """(coeff, missing, k_sample) as captionax's mixup step draws them."""
    k_coeff, k_missing, k_sample = jax.random.split(rng, 3)
    return (jax.random.uniform(k_coeff), int(jax.random.randint(k_missing, (), 0, 3)),
            k_sample)


def rng_with_missing(missing):
    for i in range(100):
        rng = jax.random.PRNGKey(i)
        if captionax_draws(rng)[1] == missing:
            return rng
    raise AssertionError("no key draws that style")


@functools.partial(jax.jit, static_argnames=("ids", "embed_fn", "alpha"))
def jax_mixup(params, clf, batch, coeff, missing, k_sample, *, ids, embed_fn, alpha):
    """jax.value_and_grad of captionax's mixup loss body (train/steps.py,
    make_hypernet_mixup_steps) -> ((loss, (ce, style, mix logits)), grads)."""
    clf_apply = jclf.classifier_soft_apply_fn(clf)
    sid = jnp.asarray(ids, jnp.int32)
    s1 = jnp.where(missing == 0, sid[1], sid[0])
    s2 = jnp.where(missing == 2, sid[1], sid[2])

    def loss_fn(params):
        theta = jhn.hypernet_apply(params["hn"], embed_fn(params, batch))
        logits = jsteps._tf_logits(params["decoder"], batch, gru_params=theta)
        ce = jlosses.cross_entropy_loss(logits, batch["captions"], 0)
        emb = jsteps.style_table(params)
        theta_mix = jhn.hypernet_apply(params["hn"], coeff * emb[s1] + (1.0 - coeff) * emb[s2])
        logits_mix = jsteps._tf_logits(params["decoder"], batch, sample_prob=1.0, rng=k_sample,
                                       gru_params=theta_mix)
        pred = clf_apply(clf, jax.nn.softmax(logits_mix, axis=-1))
        target = jlosses.mixup_style_target(coeff, missing)
        style = jnp.mean((pred - target[None, :]) ** 2)
        return alpha * ce + (1.0 - alpha) * style, (ce, style, logits_mix)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


@functools.partial(jax.jit, static_argnames=("ids", "embed_fn", "alpha"))
def jax_styleaux(params, clf, batch, *, ids, embed_fn, alpha):
    """jax.value_and_grad of captionax's style-aux loss body
    (make_hypernet_styleaux_steps) -> ((loss, (ce, aux, logits)), grads)."""
    clf_apply = jclf.classifier_soft_apply_fn(clf)
    sid = None if ids is None else jnp.asarray(ids, jnp.int32)
    rng = jax.random.PRNGKey(0)

    def loss_fn(params):
        theta = jhn.hypernet_apply(params["hn"], embed_fn(params, batch))
        logits = jsteps._tf_logits(params["decoder"], batch, gru_params=theta)
        ce = jlosses.cross_entropy_loss(logits, batch["captions"], 0)
        logits_fr = jsteps._tf_logits(params["decoder"], batch, sample_prob=1.0, rng=rng,
                                      gru_params=theta)
        pred = clf_apply(clf, jax.nn.softmax(logits_fr, axis=-1))
        cls = batch["probe_cls"] if sid is None else jnp.argmax(sid == batch["style_id"])
        aux = -jnp.mean(jnp.log(pred[:, cls] + 1e-9))
        return alpha * ce + (1.0 - alpha) * aux, (ce, aux, logits_fr)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def grad_tol(ref):
    scale = max(float(np.abs(np.asarray(ref)).max()), 1e-3)
    return dict(rtol=2e-4, atol=max(2e-5 * scale, 1e-6))


def check_grads(got, ref):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_flat = tstate.tree_leaves(got)
    assert len(ref_flat) == len(got_flat)
    for (path, a), b in zip(ref_flat, got_flat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **grad_tol(a),
                                   err_msg=jax.tree_util.keystr(path))


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def fed_back(logits):
    """The words step t > 0 of a free run feeds back: argmax of step t - 1."""
    return np.asarray(logits)[:, :-1].argmax(-1)


MIXUP_CASES = [(m, kind, ("vocab", "dedicated")[(m + i) % 2])
               for m in range(3) for i, kind in enumerate(("small", "bert"))]


@pytest.mark.parametrize("missing,kind,table", MIXUP_CASES)
def test_mixup_loss_and_gradients(missing, kind, table):
    """Each style left out, each probe kind, and each table with each probe."""
    params, ids, (jembed, tembed) = setup(table)
    clf = probe(kind)
    batch = make_batch(3 + missing, ids[missing])
    coeff, m, k_sample = captionax_draws(rng_with_missing(missing))
    assert m == missing
    alpha = 0.3
    (ref_loss, (ref_ce, ref_style, ref_mix)), ref_grads = jax_mixup(
        params, clf, batch, coeff, missing, k_sample, ids=ids, embed_fn=jembed, alpha=alpha)

    step = tsteps.make_hypernet_mixup_steps(tstate.make_optimizer(1e-3), carry(clf),
                                            alpha=alpha, style_ids=ids, embed_fn=tembed)
    tp, tb, tcoeff = carry(params), tbatch(batch), torch.tensor(np.asarray(coeff))
    theta = tsteps.mixup_theta(tp, ids, tcoeff, missing)
    mix = tsteps.free_run_logits(tp["decoder"], tb, theta)
    np.testing.assert_array_equal(fed_back(mix.detach()), fed_back(ref_mix))
    metrics, grads = step.value_and_grad(tp, tb, tcoeff, missing)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"]), float(ref_ce), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["style_loss"]), float(ref_style), rtol=1e-5)
    check_grads(grads, ref_grads)
    gru = grads["decoder"]["gru"]
    assert all(not x.any() for x in tstate.tree_leaves(gru))  # inert in hypernet mode


@pytest.mark.parametrize("table", ["vocab", "dedicated"])
@pytest.mark.parametrize("kind", ["small", "bert"])
def test_styleaux_loss_and_gradients(kind, table):
    params, ids, (jembed, tembed) = setup(table)
    clf = probe(kind)
    batch = make_batch(9, ids[2])
    alpha = 0.7
    (ref_loss, (ref_ce, ref_aux, ref_fr)), ref_grads = jax_styleaux(
        params, clf, batch, ids=ids, embed_fn=jembed, alpha=alpha)
    step = tsteps.make_hypernet_styleaux_steps(tstate.make_optimizer(1e-3), carry(clf),
                                               alpha=alpha, style_ids=ids, embed_fn=tembed)
    tp, tb = carry(params), tbatch(batch)
    fr = tsteps.free_run_logits(tp["decoder"], tb, step.theta(tp, tb))
    np.testing.assert_array_equal(fed_back(fr.detach()), fed_back(ref_fr))
    metrics, grads = step.value_and_grad(tp, tb)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"]), float(ref_ce), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["style_loss"]), float(ref_aux), rtol=1e-5)
    check_grads(grads, ref_grads)


@pytest.mark.parametrize("probe_cls", [1, 3])
def test_styleaux_probe_cls_from_batch(probe_cls):
    """style_ids=None reads the class from batch['probe_cls'] (a 4-class
    probe, as the combined Flickr+CC model uses)."""
    params, _, (jembed, tembed) = setup("vocab")
    clf = np_tree(jclf.small_style_classifier_init(jax.random.PRNGKey(8), V, 12, 4))
    batch = make_batch(10, 4)
    batch["probe_cls"] = np.asarray(probe_cls, np.int32)
    (ref_loss, (_, ref_aux, _)), ref_grads = jax_styleaux(params, clf, batch, ids=None,
                                                          embed_fn=jembed, alpha=0.7)
    step = tsteps.make_hypernet_styleaux_steps(tstate.make_optimizer(1e-3), carry(clf),
                                               style_ids=None, embed_fn=tembed)
    metrics, grads = step.value_and_grad(carry(params), tbatch(batch))
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["style_loss"]), float(ref_aux), rtol=1e-5)
    check_grads(grads, ref_grads)


def test_style_id_outside_style_ids_is_class_0():
    """argmax of an all-false match is 0, in captionax and the port."""
    params, ids, (_, tembed) = setup("vocab")
    clf = carry(probe("small"))
    step = tsteps.make_hypernet_styleaux_steps(tstate.make_optimizer(1e-3), clf,
                                               style_ids=ids, embed_fn=tembed)
    tp = carry(params)
    out = step.aux_loss(tp, tbatch(make_batch(11, 9)))
    batch0 = tbatch(make_batch(11, 9))
    pred = step.probe(tp, batch0, step.theta(tp, batch0))
    np.testing.assert_allclose(float(out), float(-torch.mean(torch.log(pred[:, 0] + 1e-9))),
                               rtol=1e-6)


@pytest.mark.parametrize("split", [False, True])
def test_mixup_train_step_matches_captionax(split):
    """One train step of each package from the same carried state: the
    metrics, and the params after Adam's step (atol 2 * lr, rtol 1e-5, as
    tests/test_torch_train.py holds make_hypernet_steps).  captionax draws
    from its rng; the port's step gets the same draws.  captionax's step
    with and without ``split``, the port's single step on both."""
    params, ids, (jembed, tembed) = setup("vocab")
    clf = probe("small")
    batch = make_batch(12, ids[0])
    lr = 1e-3
    rng = rng_with_missing(1)
    coeff, missing, _ = captionax_draws(rng)
    jtx, ttx = jstate.make_optimizer(lr), tstate.make_optimizer(lr)
    jtrain = jsteps.make_hypernet_mixup_steps(jtx, jax.tree_util.tree_map(jnp.asarray, clf),
                                              style_ids=ids, embed_fn=jembed, split=split)
    js, jm = jtrain(jstate.create_train_state(params, jtx), batch, rng)
    ttrain = tsteps.make_hypernet_mixup_steps(ttx, carry(clf), style_ids=ids, embed_fn=tembed)
    ts, tm = ttrain.apply(tstate.create_train_state(carry(params), ttx, device="cpu"), batch,
                          torch.tensor(np.asarray(coeff)), missing)
    for k in ("train_loss", "ce_loss", "style_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tstate.tree_leaves(ts.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=2 * lr)
    assert int(ts.step) == 1


def test_styleaux_train_step_matches_captionax():
    params, ids, (jembed, tembed) = setup("dedicated")
    clf = probe("bert")
    batch = make_batch(13, ids[1])
    lr = 1e-3
    jtx, ttx = jstate.make_optimizer(lr), tstate.make_optimizer(lr)
    jtrain = jsteps.make_hypernet_styleaux_steps(jtx, jax.tree_util.tree_map(jnp.asarray, clf),
                                                 style_ids=ids, embed_fn=jembed)
    js, jm = jtrain(jstate.create_train_state(params, jtx), batch, jax.random.PRNGKey(5))
    ttrain = tsteps.make_hypernet_styleaux_steps(ttx, carry(clf), style_ids=ids,
                                                 embed_fn=tembed)
    ts, tm = ttrain(tstate.create_train_state(carry(params), ttx, device="cpu"), batch,
                    torch.Generator().manual_seed(5))
    for k in ("train_loss", "ce_loss", "style_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tstate.tree_leaves(ts.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=2 * lr)


def test_mixup_draws_from_its_generator():
    """coeff in [0, 1) and missing in {0, 1, 2}, the same for the same seed."""
    step = tsteps.make_hypernet_mixup_steps(tstate.make_optimizer(1e-3), carry(probe("small")))
    draws = [step.draws(torch.Generator().manual_seed(s)) for s in range(40)]
    again = [step.draws(torch.Generator().manual_seed(s)) for s in range(40)]
    assert [(float(c), m) for c, m in draws] == [(float(c), m) for c, m in again]
    assert all(0.0 <= float(c) < 1.0 for c, _ in draws)
    assert {m for _, m in draws} == {0, 1, 2}


@pytest.mark.parametrize("missing,rows", [(0, (3, 6)), (1, (4, 6)), (2, (4, 3))])
def test_mixup_rows(missing, rows):
    assert tsteps.mixup_rows(VOCAB_IDS, missing) == rows


REFUSALS = {
    "both": (dict(mixup=True, style_aux=True), None, "at most one"),
    "mixup_split_mesh": (dict(mixup=True, mixup_split=True), object(), "single-device"),
    "style_aux_split_mesh": (dict(style_aux=True, style_aux_split=True), object(),
                             "single-device"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_harness_refuses(tmp_path, case):
    """The harness refuses both style losses at once, and a split flag with
    a mesh, as captionax's does (with ValueError)."""
    from captionax_torch.core.config import TrainConfig
    from captionax_torch.train.harness import CaptionTrainer

    flags, mesh, match = REFUSALS[case]
    cfg = TrainConfig(checkpoint_dir=str(tmp_path), **flags)
    with pytest.raises(ValueError, match=match):
        CaptionTrainer(carry(model("vocab")), "hypernet", cfg, vocab=None, mesh=mesh,
                       style_classifier_params=carry(probe("small")), device="cpu")


class HostStep:
    """A step counter that counts its reads (``int``) and adds as a tensor."""

    reads = 0

    def __init__(self, n):
        self.n = n

    def __int__(self):
        HostStep.reads += 1
        return self.n

    def __add__(self, k):
        return HostStep(self.n + k)


def test_drawing_step_counts_on_the_host(monkeypatch):
    """The harness's DrawingStep draws step n's generator for the n-th
    state, and reads the state's step only for a state it did not make:
    the first, and one put back (as lr_find puts its saved state back)."""
    from captionax_torch.train import harness

    State = collections.namedtuple("State", "step")
    drawn = []
    monkeypatch.setattr(harness, "step_generator", lambda seed, n: drawn.append((seed, n)))
    step = harness.DrawingStep(lambda state, batch, gen: (State(state.step + 1), {}), seed=4)
    HostStep.reads = 0
    start = state = State(HostStep(5))
    for _ in range(3):
        state, _ = step(state, None)
    assert drawn == [(4, 5), (4, 6), (4, 7)] and HostStep.reads == 1
    state, _ = step(start, None)
    step(state, None)
    assert drawn[3:] == [(4, 5), (4, 6)] and HostStep.reads == 2
