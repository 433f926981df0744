"""The port's training slice on the CPU against captionax, on the same
weights (carried with from_jax_params) and the same numpy inputs:
teacher_forced(_hidden), the losses, the optimizer (Adam, clip, the
non-finite skip, the injected LR), the plateau scheduler and LR sweep,
and make_hypernet_steps / make_gru_steps on both recurrence routes.
Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.models import hypernet as jhn
from captionax.models import layers as jlayers
from captionax.models import rnn as jrnn
from captionax.train import losses as jlosses
from captionax.train import state as jstate
from captionax.train import steps as jsteps
from captionax_torch.interop import from_jax_params, from_optax_state
from captionax_torch.models import decoder as tdec
from captionax_torch.models import hypernet as thn
from captionax_torch.models import layers as tlayers
from captionax_torch.models import rnn as trnn
from captionax_torch.train import losses as tlosses
from captionax_torch.train import state as tstate
from captionax_torch.train import steps as tsteps

torch.set_num_threads(1)
NF, F, E, H, V = 32, 16, 16, 16, 29
B, R, T = 8, 9, 6
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums taken in another order


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def decoder_params(num_layers=1, seed=0):
    return np_tree(jdec.attention_gru_init(jax.random.PRNGKey(seed), NF, F, E, H, V,
                                           num_layers=num_layers))


def model_params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return np_tree({"decoder": jdec.attention_gru_init(k1, NF, F, E, H, V),
                    "hn": jhn.hypernet_init(k2, hyper_emb=E, input_dim=E + F, hidden_dim=H)})


def make_batch(seed, with_style=True, pad_tail=False):
    rs = np.random.RandomState(seed)
    caps = rs.randint(1, V, (B, T)).astype(np.int32)
    if pad_tail:
        caps[:, -2:] = 0
    batch = {"features": rs.randn(B, R, NF).astype(np.float32), "captions": caps}
    if with_style:
        batch["style_id"] = np.asarray(4, np.int32)  # 'factual'
    return batch


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **(tol or F32_TOL))


# ---------------------------------------------------------------- decoder
DECODER_CASES = {
    "plain": dict(),
    "remat": dict(remat=True),
    "hoist_att1": dict(hoist_att1=True),
    "hoist_att1_remat": dict(hoist_att1=True, remat=True),
    "theta_override": dict(theta=True),
    "two_layers": dict(num_layers=2),
}


@pytest.mark.parametrize("name", sorted(DECODER_CASES))
def test_teacher_forced_hidden(name):
    kw = dict(DECODER_CASES[name])
    p = decoder_params(kw.pop("num_layers", 1))
    theta = decoder_params(seed=9)["gru"] if kw.pop("theta", False) else None
    batch = make_batch(1)
    ref_hs, ref_attn = jdec.teacher_forced_hidden(p, batch["features"], batch["captions"],
                                                  gru_params=theta, **kw)
    hs, attn = tdec.teacher_forced_hidden(carry(p), t(batch["features"]),
                                          t(batch["captions"]),
                                          gru_params=None if theta is None else carry(theta),
                                          unroll=2, **kw)
    assert tuple(hs.shape) == (B, T, H) and tuple(attn.shape) == (B, T, R)
    close(hs, ref_hs)
    close(attn, ref_attn)


def test_teacher_forced_hidden_remat_gradients():
    """remat recomputes the steps in the backward: the same gradients as
    without it, and as jax.grad of the scan (f32 tolerance)."""
    p = decoder_params()
    batch = make_batch(2)
    ref = jax.grad(lambda q: jnp.sum(jnp.tanh(jdec.teacher_forced_hidden(
        q, batch["features"], batch["captions"], remat=True)[0])))(p)
    grads = {}
    for remat in (False, True):
        tp = carry(p)
        leaves = [x.requires_grad_(True) for x in tstate.tree_leaves(tp)]
        hs, _ = tdec.teacher_forced_hidden(tp, t(batch["features"]), t(batch["captions"]),
                                           remat=remat)
        grads[remat] = torch.autograd.grad(torch.sum(torch.tanh(hs)), leaves,
                                           allow_unused=True)
    for a, b, r in zip(grads[False], grads[True], jax.tree_util.tree_leaves(ref)):
        a = torch.zeros(r.shape) if a is None else a
        b = torch.zeros(r.shape) if b is None else b
        close(b, a, rtol=1e-6, atol=1e-7)
        close(b, r)


def _jax_coins(seed):
    return np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), T),
                                         (T,)))


@pytest.mark.parametrize("sample_prob", [0.0, 0.3, 0.6, 1.0])
@pytest.mark.parametrize("remat", [False, True])
def test_teacher_forced(sample_prob, remat):
    """Pure teacher forcing, scheduled sampling with JAX's coins passed in,
    and sample_prob=1.0, where every coin passes and the port's generator
    draws do not matter."""
    p = decoder_params(num_layers=2)
    batch = make_batch(3)
    rng = jax.random.PRNGKey(7)
    ref, ref_attn = jdec.teacher_forced(p, batch["features"], batch["captions"],
                                        sample_prob=sample_prob, rng=rng, remat=remat)
    coins = None if sample_prob in (0.0, 1.0) else t(_jax_coins(7))
    gen = torch.Generator().manual_seed(123)
    logits, attn = tdec.teacher_forced(carry(p), t(batch["features"]), t(batch["captions"]),
                                       sample_prob=sample_prob, generator=gen,
                                       remat=remat, coins=coins)
    assert tuple(logits.shape) == (B, T, V)
    close(logits, ref)
    close(attn, ref_attn)


def test_teacher_forced_coins_decide_the_fed_back_words():
    """With p in (0, 1) the coins pick the steps that feed back the argmax:
    other coins give other logits; a coin per step is required."""
    p = decoder_params()
    batch = make_batch(4)
    coins = np.array([0.9, 0.1, 0.9, 0.1, 0.1, 0.9], np.float32)
    outs = [tdec.teacher_forced(carry(p), t(batch["features"]), t(batch["captions"]),
                                sample_prob=0.5, coins=t(c))[0]
            for c in (coins, 1.0 - coins)]
    assert not torch.allclose(outs[0], outs[1])
    with pytest.raises(ValueError, match="coins"):
        tdec.teacher_forced(carry(p), t(batch["features"]), t(batch["captions"]),
                            sample_prob=0.5, coins=t(coins[:3]))


# ---------------------------------------------------------------- leftovers
def test_gru_theta_size_and_unflatten():
    assert trnn.gru_theta_size(400, 200) == jrnn.gru_theta_size(400, 200) == 361200
    flat = np.random.RandomState(0).randn(trnn.gru_theta_size(E + F, H)).astype(np.float32)
    ref = jrnn.gru_theta_unflatten(jnp.asarray(flat), E + F, H)
    got = trnn.gru_theta_unflatten(t(flat), E + F, H)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_count_params():
    tree = model_params()
    assert tlayers.count_params(carry(tree)) == jlayers.count_params(tree)


def test_style_embedding_from_vocab():
    p = decoder_params()
    ref = jhn.style_embedding_from_vocab(p, jnp.asarray(4))
    np.testing.assert_array_equal(
        thn.style_embedding_from_vocab(carry(p), torch.tensor(4)).numpy(), np.asarray(ref))


# ---------------------------------------------------------------- losses
def _hs_and_caps(seed=9):
    p = decoder_params()
    batch = make_batch(seed, pad_tail=True)
    hs = np.asarray(jdec.teacher_forced_hidden(p, batch["features"], batch["captions"])[0])
    return p, hs, batch["captions"]


@pytest.mark.parametrize("pad_id", [0, None])
def test_cross_entropy_loss(pad_id):
    p, hs, caps = _hs_and_caps()
    logits = np.asarray(jlayers.linear(p["fc"], hs))
    ref = jlosses.cross_entropy_loss(logits, caps, pad_id)
    close(tlosses.cross_entropy_loss(t(logits), t(caps), pad_id), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [B * T, 16, 7])  # exact, divides, needs padding
@pytest.mark.parametrize("remat", [False, True])
def test_fused_ce_from_hidden(chunk, remat):
    """Equals captionax's and the port's CE of the full logits, in value
    and gradient (rtol 1e-6 on the value, 1e-5 / atol 1e-7 on the
    gradients, the tolerances of tests/test_hypernet_train.py)."""
    p, hs, caps = _hs_and_caps()
    ref = jlosses.fused_ce_from_hidden(p["fc"], hs, caps, 0, chunk_rows=chunk, remat=remat)
    g_ref = jax.grad(lambda fc, h: jlosses.fused_ce_from_hidden(fc, h, caps, 0, chunk),
                     argnums=(0, 1))(p["fc"], hs)
    fc = carry(p["fc"])
    h = t(hs)
    for x in (fc["w"], fc["b"], h):
        x.requires_grad_(True)
    got = tlosses.fused_ce_from_hidden(fc, h, t(caps), 0, chunk_rows=chunk, remat=remat)
    full = tlosses.cross_entropy_loss(tlayers.linear(fc, h), t(caps), 0)
    close(got, ref, rtol=1e-6, atol=0)
    close(got, full.detach(), rtol=1e-6, atol=0)
    grads = torch.autograd.grad(got, [fc["b"], fc["w"], h])
    for a, b in zip(jax.tree_util.tree_leaves(g_ref), grads):
        close(b, a, rtol=1e-5, atol=1e-7)


def test_fused_ce_mixed_dtypes():
    """f32 hidden states against bf16 fc weights (the K3 route under bf16):
    the product runs in f32, as JAX promotes; rtol 1e-6."""
    p, hs, caps = _hs_and_caps()
    fc16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), p["fc"])
    ref = jlosses.fused_ce_from_hidden(fc16, hs, caps, 0, chunk_rows=7)
    got = tlosses.fused_ce_from_hidden(
        from_jax_params(p["fc"], device="cpu", dtype=torch.bfloat16), t(hs), t(caps), 0,
        chunk_rows=7)
    close(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_loss(smoothing):
    p, hs, caps = _hs_and_caps()
    logits = np.asarray(jlayers.linear(p["fc"], hs))
    ref = jlosses.label_smoothing_loss(logits, caps, smoothing)
    close(tlosses.label_smoothing_loss(t(logits), t(caps), smoothing), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("missing", [0, 1, 2])
def test_mixup_style_target(missing):
    ref = jlosses.mixup_style_target(jnp.asarray(0.3), missing)
    np.testing.assert_array_equal(
        tlosses.mixup_style_target(torch.tensor(0.3), missing).numpy(), np.asarray(ref))


# ---------------------------------------------------------------- optimizer
def _opt_params():
    rs = np.random.RandomState(0)
    return {"a": {"w": rs.randn(6, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)},
            "c": [rs.randn(4).astype(np.float32), rs.randn(3, 2).astype(np.float32)]}


def _grads(seed, scale=1.0, nan=False):
    rs = np.random.RandomState(100 + seed)
    g = jax.tree_util.tree_map(lambda x: (rs.randn(*x.shape) * scale).astype(np.float32),
                               _opt_params())
    if nan:
        g["a"]["w"][2, 3] = np.nan
    return g


# (grad scale, NaN, learning rate set before the step): plain steps, a
# clipped one (global norm well above 5), a skipped NaN step, a new LR
OPT_STEPS = [(0.1, False, None), (10.0, False, None), (0.1, True, None),
             (0.3, False, 2e-2), (20.0, False, None)]
OPT_TOL = dict(rtol=1e-5, atol=1e-7)  # f32, the global norm summed in another order


def _compare_states(js, ts, what):
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tstate.tree_leaves(ts.params)):
        close(b, a, **OPT_TOL)
    conv = from_optax_state(np_tree(js.opt_state), device="cpu")
    for field in ("mu", "nu"):
        for a, b in zip(tstate.tree_leaves(getattr(conv.adam, field)),
                        tstate.tree_leaves(getattr(ts.opt_state.adam, field))):
            close(b, a, **OPT_TOL)
    assert int(conv.adam.count) == int(ts.opt_state.adam.count), what
    assert int(conv.notfinite_count) == int(ts.opt_state.notfinite_count), what
    assert int(conv.total_notfinite) == int(ts.opt_state.total_notfinite), what
    assert int(js.step) == int(ts.step), what
    assert jstate.get_lr(js) == pytest.approx(tstate.get_lr(ts), rel=1e-7)


def test_optimizer_matches_optax_over_five_steps():
    jtx, ttx = jstate.make_optimizer(1e-2), tstate.make_optimizer(1e-2)
    js = jstate.create_train_state(_opt_params(), jtx)
    ts = tstate.create_train_state(carry(_opt_params()), ttx, device="cpu")
    _compare_states(js, ts, "init")
    for i, (scale, nan, lr) in enumerate(OPT_STEPS):
        if lr is not None:
            js, ts = jstate.set_lr(js, lr), tstate.set_lr(ts, lr)
        g = _grads(i, scale, nan)
        before = [x.clone() for x in tstate.tree_leaves(ts.params)]
        js = js.apply_gradients(g, jtx)
        ts = ts.apply_gradients(carry(g), ttx)
        _compare_states(js, ts, f"step {i}")
        if nan:  # dropped: nothing moved, Adam's count kept
            for a, b in zip(before, tstate.tree_leaves(ts.params)):
                assert torch.equal(a, b)
    assert int(ts.opt_state.adam.count) == 4 and int(ts.step) == 5


def test_clip_uses_optax_rule():
    """Below the norm the gradient passes untouched; above it the update is
    (g / norm) * max_norm, not clip_grad_norm_'s max_norm / (norm + 1e-6)."""
    ttx = tstate.make_optimizer(1e-3, clip_norm=5.0)
    ts = tstate.create_train_state(carry(_opt_params()), ttx, device="cpu")
    g = carry(_grads(0, 10.0))
    norm = torch.sqrt(sum(torch.sum(x * x) for x in tstate.tree_leaves(g)))
    assert norm > 5.0
    _, st = ttx.update(g, ts.opt_state)
    for m, x in zip(tstate.tree_leaves(st.adam.mu), tstate.tree_leaves(g)):
        torch.testing.assert_close(m, 0.1 * ((x / norm) * 5.0), rtol=1e-6, atol=0)


def test_nonfinite_steps_apply_after_100_in_a_row():
    """apply_if_finite(max_consecutive_errors=100): 100 NaN steps in a row
    are dropped, the 101st is applied (its NaN reaches the parameters)."""
    jtx, ttx = jstate.make_optimizer(1e-2), tstate.make_optimizer(1e-2)
    js = jstate.create_train_state(_opt_params(), jtx)
    ts = tstate.create_train_state(carry(_opt_params()), ttx, device="cpu")
    g = _grads(0, 1.0, nan=True)
    jstep = jax.jit(lambda s: s.apply_gradients(g, jtx))
    tg = carry(g)
    for _ in range(100):
        js, ts = jstep(js), ts.apply_gradients(tg, ttx)
    _compare_states(js, ts, "100 dropped")
    assert int(ts.opt_state.notfinite_count) == 100
    js, ts = jstep(js), ts.apply_gradients(tg, ttx)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tstate.tree_leaves(ts.params)):
        np.testing.assert_array_equal(np.isnan(b.numpy()), np.isnan(np.asarray(a)))
    assert int(ts.opt_state.adam.count) == 1 and bool(torch.isnan(ts.params["a"]["w"]).all())


def test_plateau_scheduler_matches():
    metrics = [1.0, 1.1, 1.2, 0.9, 0.95, 0.97, 0.96, 0.98, 0.8, 0.85, 0.9, 0.91, 0.92]
    js, ts = jstate.PlateauScheduler(patience=1, cooldown=2), \
        tstate.PlateauScheduler(patience=1, cooldown=2)
    jl = tl = 1e-2
    for m in metrics:
        jl, tl = js.step(m, jl), ts.step(m, tl)
        assert tl == jl
        assert (ts.best, ts.bad_epochs, ts.cooldown_left) == \
            (js.best, js.bad_epochs, js.cooldown_left)
    assert tl < 1e-2


@pytest.mark.parametrize("curve", ["smooth", "diverges_late", "diverges_early", "all_nan"])
def test_suggest_lr_from_sweep_matches(curve):
    lrs = np.geomspace(1e-6, 1.0, 40)
    losses = 3.0 - np.tanh(np.linspace(-3, 3, 40)) + 0.01 * np.sin(np.arange(40))
    if curve == "diverges_late":
        losses[30:] = np.inf
    elif curve == "diverges_early":
        losses[8:] = np.nan
    elif curve == "all_nan":
        losses[:] = np.nan
    ref = jstate.suggest_lr_from_sweep(lrs, losses)
    assert tstate.suggest_lr_from_sweep(lrs, losses) == ref


# ---------------------------------------------------------------- train steps
def _jax_loss_fn(kind, batch, bf16, fused):
    if kind == "hypernet":
        def loss(p):
            theta = jhn.hypernet_apply(p["hn"], jsteps.style_token_embed(p, batch))
            return jsteps._tf_ce(p["decoder"], batch, 0, gru_params=theta, bf16=bf16,
                                 fused=fused)
    else:
        def loss(p):
            return jsteps._tf_ce(p, batch, 0, bf16=bf16, fused=fused)
    return loss


def _port_loss_fn(kind, batch, bf16, fused):
    if kind == "hypernet":
        def loss(p):
            theta = thn.hypernet_apply(p["hn"], tsteps.style_token_embed(p, batch))
            return tsteps._tf_ce(p["decoder"], batch, 0, gru_params=theta, bf16=bf16,
                                 fused=fused)
    else:
        def loss(p):
            return tsteps._tf_ce(p, batch, 0, bf16=bf16, fused=fused)
    return loss


def _kind_setup(kind, seed=11):
    params = model_params() if kind == "hypernet" else decoder_params()
    batch = make_batch(seed, with_style=kind == "hypernet", pad_tail=True)
    return params, batch


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def _grad_tol(ref):
    """f32: rtol 2e-4, atol max(2e-5 * scale, 1e-6), tests/test_train_kernel.py's
    gradient tolerance (the floor covers v_a's bias, whose exact gradient is
    0 and which both routes give as float noise or 0)."""
    scale = max(float(np.abs(np.asarray(ref)).max()), 1e-3)
    return dict(rtol=2e-4, atol=max(2e-5 * scale, 1e-6))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["hypernet", "gru"])
def test_loss_and_gradients_match_jax(kind, fused):
    params, batch = _kind_setup(kind)
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss_fn(kind, batch, False, fused))(params)
    loss, grads = tsteps._value_and_grad(_port_loss_fn(kind, _tbatch(batch), False, fused),
                                         carry(params))
    close(loss, ref_loss, rtol=1e-6, atol=0)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    got_flat = tstate.tree_leaves(grads)
    assert len(ref_flat) == len(got_flat)
    for (path, a), b in zip(ref_flat, got_flat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **_grad_tol(a),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["hypernet", "gru"])
def test_train_step_matches_jax(kind, fused):
    """One step of the port's train_step against captionax's, from the same
    carried init: the loss, and the parameters after the step.  Adam's
    first step moves each element by about lr * sign(g), so a gradient at
    float-noise level (v_a's bias) can move either way: atol 2 * lr on the
    parameters, rtol 1e-5; everything else agrees far closer."""
    params, batch = _kind_setup(kind, seed=12)
    lr = 1e-3
    jtx, ttx = jstate.make_optimizer(lr), tstate.make_optimizer(lr)
    makers = {"hypernet": (jsteps.make_hypernet_steps, tsteps.make_hypernet_steps),
              "gru": (jsteps.make_gru_steps, tsteps.make_gru_steps)}[kind]
    jtrain = makers[0](jtx, fused_scan=fused)[0]
    ttrain = makers[1](ttx, fused_scan=fused)[0]
    js, jm = jtrain(jstate.create_train_state(params, jtx), batch)
    ts, tm = ttrain(tstate.create_train_state(carry(params), ttx, device="cpu"), batch)
    close(tm["train_loss"], jm["train_loss"], rtol=1e-6, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(js.params), tstate.tree_leaves(ts.params)):
        close(b, a, rtol=1e-5, atol=2 * lr)
    moved = sum(int(not np.allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-6))
                for a, b in zip(jax.tree_util.tree_leaves(js.params),
                                tstate.tree_leaves(ts.params)))
    assert moved <= 1  # at most v_a's bias
    assert int(ts.step) == 1


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_matches_jax_scan(fused):
    """bf16 compute over f32 masters, against jax.value_and_grad of the JAX
    scan step in bf16 (not its kernel, whose bf16 gradients captionax never
    tests).  bf16 keeps 8 bits and the two frameworks round at different
    places (the K3 route keeps hs in f32), so each gradient is held to the
    distance of JAX's own bf16 gradient from its f32 one: no more than twice
    that, plus 1% of the f32 gradient's largest entry (JAX's bf16 attention
    gradients are 8-15% of it off their f32 values).  The loss: rtol 1e-3."""
    params, batch = _kind_setup("hypernet")
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss_fn("hypernet", batch, True, False))(
        params)
    f32_grads = jax.grad(_jax_loss_fn("hypernet", batch, False, False))(params)
    loss, grads = tsteps._value_and_grad(
        _port_loss_fn("hypernet", _tbatch(batch), True, fused), carry(params))
    close(loss, ref_loss, rtol=1e-3, atol=0)
    for (path, a), b, c in zip(jax.tree_util.tree_flatten_with_path(ref_grads)[0],
                               tstate.tree_leaves(grads), jax.tree_util.tree_leaves(f32_grads)):
        assert b.dtype == torch.float32
        a, c = np.asarray(a, np.float32), np.asarray(c)
        scale = max(float(np.abs(c).max()), 1e-6)
        own = float(np.abs(a - c).max())
        err = float(np.abs(b.numpy() - a).max())
        assert err <= 2 * own + 1e-2 * scale, (jax.tree_util.keystr(path), err, own, scale)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_steps_train_on_f32_masters(fused):
    """Five bf16 steps on one batch: every loss finite, the last below the
    first, the masters still f32."""
    params, batch = _kind_setup("hypernet")
    ttx = tstate.make_optimizer(1e-2)
    train, _ = tsteps.make_hypernet_steps(ttx, bf16=True, fused_scan=fused)
    ts = tstate.create_train_state(carry(params), ttx, device="cpu")
    losses = []
    for _ in range(5):
        ts, m = train(ts, batch)
        losses.append(float(m["train_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(x.dtype == torch.float32 for x in tstate.tree_leaves(ts.params))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_decoder_gru_frozen_in_hypernet_mode(fused, bf16):
    params, batch = _kind_setup("hypernet")
    ttx = tstate.make_optimizer(1e-2)
    train, _ = tsteps.make_hypernet_steps(ttx, fused_scan=fused, bf16=bf16)
    ts = tstate.create_train_state(carry(params), ttx, device="cpu")
    before = {k: v.clone() for k, v in ts.params["decoder"]["gru"].items()}
    for _ in range(2):
        ts, _ = train(ts, batch)
    for k, v in before.items():
        assert torch.equal(v, ts.params["decoder"]["gru"][k]), k
    assert not torch.equal(ts.params["decoder"]["fc"]["w"], carry(params)["decoder"]["fc"]["w"])


@pytest.mark.parametrize("kind", ["hypernet", "gru"])
def test_eval_step_matches_jax(kind):
    params, batch = _kind_setup(kind, seed=13)
    jbuild = jsteps.make_hypernet_steps if kind == "hypernet" else jsteps.make_gru_steps
    tbuild = tsteps.make_hypernet_steps if kind == "hypernet" else tsteps.make_gru_steps
    ref = jbuild(jstate.make_optimizer(1e-3))[1](params, batch)
    got = tbuild(tstate.make_optimizer(1e-3))[1](carry(params), batch)
    for k in ("val_loss_tf", "val_loss", "logits_tf"):
        close(got[k], ref[k])
