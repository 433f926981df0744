"""The port's training harness on the CPU against captionax's: ``fit`` from
the same weights (carried with ``from_jax_params``) on identical
precomputed-feature batches, on both recurrence routes (captionax's fused
route runs its kernel in interpret mode, as its own tests run it), then
``validate``, ``test_beam`` and ``lr_find``; the checkpoints (the port's
own format: round trips, pruning, ``latest_step``, the train state, module
surgery); ``FeatureCache``;
``BatchLoader``; the config dataclasses; the synthetic data and the
FlickrStyle batch stream.  Tolerances are stated where they are used."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from captionax.core import config as jconfig
from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.core.vocab import extract_factual_caption_lines as jextract
from captionax.data import flickr as jflickr
from captionax.data import synthetic as jsynth
from captionax.decode import search as jsearch
from captionax.models import decoder as jdec
from captionax.models import hypernet as jhn
from captionax.train import harness as jharness
from captionax.train import steps as jsteps
from captionax.train.checkpoint import latest_step as jlatest_step
from captionax_torch.core import config as tconfig
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.core.vocab import extract_factual_caption_lines as textract
from captionax_torch.data import flickr as tflickr
from captionax_torch.data import synthetic as tsynth
from captionax_torch.data.loader import BatchLoader
from captionax_torch.decode import search as tsearch
from captionax_torch.interop import from_jax_params
from captionax_torch.train import checkpoint as tckpt
from captionax_torch.train import harness as tharness
from captionax_torch.train import steps as tsteps
from captionax_torch.train.state import get_lr, tree_leaves
from tests.fixtures.gru_fixture import CAPTIONS, flags

torch.set_num_threads(1)
NF, F, E, H = 24, 16, 16, 16
B, R, T = 4, 9, 10
LOSS_RTOL = 1e-5                       # per-step train loss, relative
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)  # final params after 6 Adam steps
VAL_TOL = 1e-5
METRIC_TOL = 1e-6


@pytest.fixture(scope="module")
def vocabs():
    jv = jbuild_vocab(jextract(CAPTIONS))
    tv = tbuild_vocab(textract(CAPTIONS))
    assert jv.w2i == tv.w2i
    return jv, tv


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(kind, V, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    decoder = jdec.attention_gru_init(k1, NF, F, E, H, V)
    if kind == "gru":
        return np_tree(decoder)
    return np_tree({"decoder": decoder,
                    "hn": jhn.hypernet_init(k2, hyper_emb=E, input_dim=E + F, hidden_dim=H)})


def feature_batches(V, n_batches=3, seed=0, style=True):
    """Host batches of precomputed features and captions ``<s> w.. </s>``."""
    rs = np.random.RandomState(seed)
    for i in range(n_batches):
        caps = np.zeros((B, T), np.int32)
        for r in range(B):
            n = rs.randint(3, T - 1)
            caps[r, 0], caps[r, 1:n + 1], caps[r, n + 1] = 1, rs.randint(4, V, n), 2
        batch = {"features": rs.randn(B, R, NF).astype(np.float32), "captions": caps,
                 "lengths": (caps != 0).sum(1).astype(np.int32)}
        if style:
            batch["style_id"] = np.int32((4, 3, 6)[i % 3])
        yield batch


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_tree_close(got, ref, noise_atol=None, **tol):
    """Every leaf within ``tol``.  With ``noise_atol``, v_a's bias is held to
    that absolute bound instead: its exact gradient is 0 (softmax shift
    invariance), both sides give it as float noise (``assert_va_bias_noise``
    measures it), and Adam turns any noise into a step of about lr, either
    way (as tests/test_torch_train.py bounds it, 2 lr a step)."""
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = tree_leaves(got)
    assert len(ref_flat) == len(got_leaves)
    for (path, b), a in zip(ref_flat, got_leaves):
        name = jax.tree_util.keystr(path)
        if noise_atol is not None and name.endswith("['v_a']['b']"):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                       atol=noise_atol, err_msg=name)
        else:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **tol)


VA_BIAS_NOISE = 1e-6  # |d(v_a bias)| relative to the largest gradient entry


def assert_va_bias_noise(kind, params, batch, fused):
    """Both sides' first-step gradients of v_a's bias are at rounding level,
    at most VA_BIAS_NOISE of the largest gradient entry over all leaves: the
    leaf that ``assert_tree_close`` holds to ``noise_atol`` alone."""
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if kind == "hypernet":
        def jloss(p):
            theta = jhn.hypernet_apply(p["hn"], jsteps.style_token_embed(p, batch))
            return jsteps._tf_ce(p["decoder"], batch, 0, gru_params=theta, fused=fused)

        def tloss(p):
            theta = tharness.hypernet_apply(p["hn"], tsteps.style_token_embed(p, tbatch))
            return tsteps._tf_ce(p["decoder"], tbatch, 0, gru_params=theta, fused=fused)
    else:
        def jloss(p):
            return jsteps._tf_ce(p, batch, 0, fused=fused)

        def tloss(p):
            return tsteps._tf_ce(p, tbatch, 0, fused=fused)
    jgrads = jax.grad(jloss)(params)
    tgrads = tsteps._value_and_grad(tloss, from_jax_params(params, device="cpu"))[1]
    dec_j = jgrads if kind == "gru" else jgrads["decoder"]
    dec_t = tgrads if kind == "gru" else tgrads["decoder"]
    for side, leaves, va_b in (
            ("captionax", [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)],
             np.asarray(dec_j["attention"]["v_a"]["b"])),
            ("port", [x.numpy() for x in tree_leaves(tgrads)],
             dec_t["attention"]["v_a"]["b"].numpy())):
        scale = max(float(np.abs(x).max()) for x in leaves)
        assert float(np.abs(va_b).max()) <= VA_BIAS_NOISE * scale, (side, va_b, scale)


def assert_metrics(got, ref, tol):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= tol, (k, got[k], ref[k])


# ------------------------------------------------------------------- fit
FIT_CASES = {
    "hypernet_loop": ("hypernet", False),
    "hypernet_fused": ("hypernet", True),
    "gru_loop": ("gru", False),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_captionax(vocabs, tmp_path, case):
    """Two epochs of three batches each, validation after each epoch
    (plateau patience 0, so an epoch without improvement halves the LR),
    top-1 checkpoint: every step's loss and LR, the checkpointed step, the
    final params, validate and test_beam."""
    kind, fused = FIT_CASES[case]
    jv, tv = vocabs
    V = len(jv)
    style = kind == "hypernet"
    params = jax_model(kind, V)
    common = dict(max_epochs=2, batch_size=B, lr=5e-3, log_every=1, plateau_patience=0,
                  plateau_cooldown=0, beam_max_steps=8, fused_scan=fused)
    jcfg = jconfig.TrainConfig(checkpoint_dir=str(tmp_path / "jax"), **common)
    tcfg = tconfig.TrainConfig(checkpoint_dir=str(tmp_path / "port"), **common)
    jt = jharness.CaptionTrainer(jax.tree_util.tree_map(np.array, params), kind, jcfg, jv,
                                 run_name="fit")
    tt = tharness.CaptionTrainer(from_jax_params(params, device="cpu"), kind, tcfg, tv,
                                 run_name="fit", device="cpu")
    train = lambda epoch: feature_batches(V, seed=epoch, style=style)  # noqa: E731
    val = lambda: feature_batches(V, n_batches=1, seed=99, style=style)  # noqa: E731
    assert_va_bias_noise(kind, params, next(train(0)), fused)
    jh, th = jt.fit(train, val), tt.fit(train, val)

    jlog, tlog = read_log(jt.logger.path), read_log(tt.logger.path)
    jsteps = [r for r in jlog if "train_loss" in r]
    tsteps = [r for r in tlog if "train_loss" in r]
    assert [r["step"] for r in tsteps] == [r["step"] for r in jsteps] == list(range(1, 7))
    np.testing.assert_allclose([r["train_loss"] for r in tsteps],
                               [r["train_loss"] for r in jsteps], rtol=LOSS_RTOL)
    assert [r["lr"] for r in tsteps] == [r["lr"] for r in jsteps]
    assert get_lr(tt.state) == float(jt.state.opt_state.hyperparams["learning_rate"])
    for e in (0, 1):
        for k in ("train_loss_epoch", "val_loss_tf", "val_loss"):
            assert abs(th[e][k] - jh[e][k]) <= VAL_TOL * abs(jh[e][k]), (e, k)
    assert tckpt.latest_step(tcfg.checkpoint_dir) == jlatest_step(jcfg.checkpoint_dir)
    noise = 2 * common["lr"] * 6
    assert_tree_close(tt.params, np_tree(jt.params), noise_atol=noise, **PARAM_TOL)
    assert_tree_close(tckpt.restore_checkpoint(tcfg.checkpoint_dir), np_tree(jt.params),
                      noise_atol=noise, **PARAM_TOL)

    if kind == "gru":
        return  # the decode checks below are the same code for both kinds
    # validate and test_beam on each side's own final params
    vb = lambda: feature_batches(V, n_batches=2, seed=7, style=style)  # noqa: E731
    assert_metrics(tt.validate(vb()), jt.validate(vb()), VAL_TOL)
    assert_metrics(tt.test_beam(vb()), jt.test_beam(vb()), METRIC_TOL)
    for batch in vb():
        if kind == "gru":
            dec_j, dec_t, th_j, th_t = jt.params, tt.params, None, None
        else:
            dec_j, dec_t = jt.params["decoder"], tt.params["decoder"]
            th_j = jhn.hypernet_apply(jt.params["hn"], jt.params["decoder"]["embed"][4])
            th_t = tharness.hypernet_apply(tt.params["hn"], tt.params["decoder"]["embed"][4])
        ref = jsearch.beam_search(dec_j, batch["features"], k=3, max_steps=8, gru_params=th_j)
        got = tsearch.beam_search(dec_t, torch.from_numpy(batch["features"]), k=3,
                                  max_steps=8, gru_params=th_t, device="cpu")
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))


def test_lr_find_matches_captionax(vocabs, tmp_path):
    """The sweep's suggestion is captionax's, the state is restored bit for
    bit and the suggested LR installed."""
    jv, tv = vocabs
    V = len(jv)
    params = jax_model("hypernet", V)
    jt = jharness.CaptionTrainer(jax.tree_util.tree_map(np.array, params), "hypernet",
                                 jconfig.TrainConfig(checkpoint_dir=str(tmp_path / "j")), jv)
    tt = tharness.CaptionTrainer(from_jax_params(params, device="cpu"), "hypernet",
                                 tconfig.TrainConfig(checkpoint_dir=str(tmp_path / "t")), tv,
                                 device="cpu")
    before = [x.clone() for x in tree_leaves(tt.params)]
    train = lambda epoch: feature_batches(V, seed=epoch)  # noqa: E731
    ref = jt.lr_find(train, num_training=20)
    got = tt.lr_find(train, num_training=20)
    assert got == ref and got is not None
    assert get_lr(tt.state) == float(jt.state.opt_state.hyperparams["learning_rate"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tt.params), before))
    assert int(tt.state.step) == 0 and tt.global_step == 0


def test_auto_lr_find_in_fit(vocabs, tmp_path):
    jv, tv = vocabs
    V = len(jv)
    cfg = tconfig.TrainConfig(max_epochs=1, batch_size=B, checkpoint_dir=str(tmp_path),
                              auto_lr_find=True, lr_find_steps=15)
    tt = tharness.CaptionTrainer(from_jax_params(jax_model("gru", V), device="cpu"), "gru",
                                 cfg, tv, device="cpu")
    hist = tt.fit(lambda epoch: feature_batches(V, seed=epoch, style=False))
    assert np.isfinite(hist[0]["train_loss_epoch"])
    assert [r for r in read_log(tt.logger.path) if "lr_find_suggestion" in r]


def test_fit_under_trace_writes_profile(vocabs, tmp_path):
    jv, tv = vocabs
    V = len(jv)
    cfg = tconfig.TrainConfig(max_epochs=1, batch_size=B, checkpoint_dir=str(tmp_path),
                              trace_dir=str(tmp_path / "trace"))
    tt = tharness.CaptionTrainer(from_jax_params(jax_model("gru", V), device="cpu"), "gru",
                                 cfg, tv, device="cpu")
    tt.fit(lambda epoch: feature_batches(V, n_batches=1, style=False))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


@pytest.mark.parametrize("what", ("mesh", "mixup", "style_aux"))
def test_unported_options_raise(vocabs, tmp_path, what):
    """mixup and style_aux raise without the classifier that scores them, as
    captionax's harness refuses them.  mesh is ported: a mesh of one slot
    trains as no mesh does, bit for bit; a mesh of two slots in one process
    raises (training over several devices runs one process per rank,
    tests/test_torch_parallel_train.py)."""
    jv, tv = vocabs
    kind = "gru" if what == "mesh" else "hypernet"
    if what == "mesh":
        from captionax_torch.parallel import make_mesh

        hists = []
        for mesh in (None, make_mesh(devices=["cpu"])):
            cfg = tconfig.TrainConfig(max_epochs=1, batch_size=B,
                                      checkpoint_dir=str(tmp_path / str(mesh is None)))
            tt = tharness.CaptionTrainer(from_jax_params(jax_model(kind, len(jv)), device="cpu"),
                                         kind, cfg, tv, mesh=mesh, device="cpu")
            hists.append(tt.fit(lambda epoch: feature_batches(len(jv), style=False),
                                lambda: feature_batches(len(jv), n_batches=1, style=False)))
        for key in ("train_loss_epoch", "val_loss_tf", "val_loss"):
            assert hists[0][0][key] == hists[1][0][key], key
        with pytest.raises(ValueError, match="one process per rank"):
            tharness.CaptionTrainer(from_jax_params(jax_model(kind, len(jv)), device="cpu"),
                                    kind, cfg, tv, mesh=make_mesh(devices=["cpu", "cpu"]))
        return
    cfg = tconfig.TrainConfig(checkpoint_dir=str(tmp_path),
                              mixup=what == "mixup", style_aux=what == "style_aux")
    with pytest.raises(ValueError, match=f"{what} needs style_classifier_params"):
        tharness.CaptionTrainer(from_jax_params(jax_model(kind, len(jv)), device="cpu"),
                                kind, cfg, tv, device="cpu")


def test_default_device_is_the_card(vocabs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    jv, tv = vocabs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tharness.CaptionTrainer(from_jax_params(jax_model("gru", len(jv)), device="cpu"),
                                "gru", tconfig.TrainConfig(checkpoint_dir=str(tmp_path)), tv)


# ------------------------------------------------------------ checkpoints
def sample_tree():
    g = torch.Generator().manual_seed(0)
    return {"decoder": {"w": torch.randn(3, 4, generator=g),
                        "layers": [{"b": torch.randn(5, generator=g)},
                                   {"b": torch.randn(5, generator=g)}]},
            "count": torch.tensor(7, dtype=torch.int32),
            "half": torch.randn(2, 2, generator=g).to(torch.bfloat16)}


def test_checkpoint_round_trip_exact(tmp_path):
    tree = sample_tree()
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, 3, tree)
    for back in (tckpt.restore_checkpoint(d), tckpt.restore_checkpoint(d, like=tree),
                 tckpt.restore_checkpoint(d, step=3, like=tree)):
        assert tree_leaves(back) and len(tree_leaves(back)) == len(tree_leaves(tree))
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    raw = torch.load(os.path.join(d, "3", tckpt.TREE_FILE), weights_only=True)
    assert isinstance(raw["decoder"]["layers"], list)


@pytest.mark.parametrize("change", ("shape", "dtype", "keys", "list"))
def test_restore_checks_like(tmp_path, change):
    tree = sample_tree()
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, 1, tree)
    like = sample_tree()
    if change == "shape":
        like["decoder"]["w"] = torch.zeros(4, 3)
    elif change == "dtype":
        like["count"] = torch.tensor(7, dtype=torch.int64)
    elif change == "keys":
        like["extra"] = torch.zeros(1)
    else:
        like["decoder"]["layers"].pop()
    with pytest.raises(ValueError, match="checkpoint tree"):
        tckpt.restore_checkpoint(d, like=like)


def test_max_to_keep_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d)
    os.makedirs(d)
    with open(os.path.join(d, "run_eval.jsonl"), "w") as f:
        f.write("{}\n")
    os.makedirs(os.path.join(d, "99.tmp"))
    os.makedirs(os.path.join(d, "50"))  # a step directory with no tree
    for step in (2, 4, 6):
        tckpt.save_checkpoint(d, step, sample_tree(), max_to_keep=2)
    assert sorted(n for n in os.listdir(d) if n.isdigit()) == ["4", "50", "6"]
    assert tckpt.latest_step(d) == 6
    tckpt.save_checkpoint(d, 8, sample_tree(), max_to_keep=1)
    assert tckpt.latest_step(d) == 8 and not os.path.exists(os.path.join(d, "6"))
    assert os.path.exists(os.path.join(d, "run_eval.jsonl"))


def test_train_state_round_trip(vocabs, tmp_path):
    """After three train steps: params, Adam's moments and count, the
    non-finite counters, the LR and the step come back exactly."""
    jv, tv = vocabs
    V = len(jv)
    tt = tharness.CaptionTrainer(from_jax_params(jax_model("hypernet", V), device="cpu"),
                                 "hypernet", tconfig.TrainConfig(checkpoint_dir=str(tmp_path)),
                                 tv, device="cpu")
    state = tt.state
    for batch in feature_batches(V):
        state, _ = tt._train_step(state, batch)
    d = str(tmp_path / "state")
    tckpt.save_train_state(d, 3, state)
    back = tckpt.restore_train_state(d, tt.state)
    assert type(back.opt_state) is type(state.opt_state)
    assert type(back.opt_state.adam) is type(state.opt_state.adam)
    assert int(back.step) == 3 and int(back.opt_state.adam.count) == 3
    for a, b in zip(tree_leaves([back.params, list(back.opt_state)]),
                    tree_leaves([state.params, list(state.opt_state)])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_graft_pretrained_captioner(vocabs):
    jv, _ = vocabs
    model = from_jax_params(jax_model("hypernet", len(jv)), device="cpu")
    donor = from_jax_params(jax_model("gru", len(jv), seed=9), device="cpu")
    grafted = tckpt.graft_pretrained_captioner(model, donor)
    assert tckpt.SHARED_SUBMODULES == ("feature_fc", "embed", "fc", "attention", "init_h")
    for name in tckpt.SHARED_SUBMODULES:
        assert grafted["decoder"][name] is donor[name]
    assert grafted["decoder"]["gru"] is model["decoder"]["gru"]
    assert grafted["hn"] is model["hn"]


def test_maybe_resume(vocabs, tmp_path):
    jv, tv = vocabs
    V = len(jv)
    d = str(tmp_path / "ck")
    trained = from_jax_params(jax_model("gru", V, seed=3), device="cpu")
    tckpt.save_checkpoint(d, 17, trained)
    tt = tharness.CaptionTrainer(from_jax_params(jax_model("gru", V), device="cpu"), "gru",
                                 tconfig.TrainConfig(checkpoint_dir=d), tv, device="cpu")
    assert tt.maybe_resume() and tt.global_step == 17
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tt.params), tree_leaves(trained)))
    assert not tt.maybe_resume(str(tmp_path / "empty"))


# ---------------------------------------------------------- feature cache
def fake_encoder(calls):
    def encode(_params, images):
        x = torch.as_tensor(np.asarray(images)).float()
        calls.append(len(x))
        base = x.mean(dim=(1, 2, 3))[:, None, None]
        return torch.sin(base + torch.arange(R * NF).reshape(1, R, NF) * 0.37) * 3.1
    return encode


def image_batches(n_batches=3, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 255, (n_batches * B, 8, 8, 3)).astype(np.uint8)
    for i in range(n_batches):
        idx = np.arange(i * B, (i + 1) * B)
        yield {"images": imgs[idx], "indices": idx, "index_ns": "flickr"}


@pytest.mark.parametrize("device", (False, True))
def test_feature_cache_encodes_once(device):
    calls = []
    cache = tharness.FeatureCache(fake_encoder(calls), {}, device=device)
    plain = fake_encoder([])
    for epoch in range(3):
        for b in image_batches():
            got = cache.featurize(lambda: b["images"], b["indices"], b["index_ns"])
            ref = plain(None, b["images"])
            got = torch.as_tensor(got)
            assert got.dtype == torch.float32 and got.shape == (B, R, NF)
            # cached rows went through f16
            torch.testing.assert_close(got, ref.to(torch.float16).float(), rtol=0, atol=0)
    assert calls == [B] * 3  # each image once, in epoch 0
    # a batch with one new image encodes the whole batch again (captionax's rule)
    idx = np.array([0, 1, 2, 99])
    cache.featurize(lambda: np.zeros((4, 8, 8, 3), np.uint8), idx, "flickr")
    assert calls == [B] * 3 + [4]
    assert ("flickr", 99) in cache and ("cc", 0) not in cache


def test_feature_cache_device_table_matches_host_store():
    host = tharness.FeatureCache(fake_encoder([]), {}, device=False)
    table = tharness.FeatureCache(fake_encoder([]), {}, device=True)
    for b in list(image_batches(5)) + list(image_batches(2, seed=1)):
        a = host.featurize(lambda: b["images"], b["indices"])
        t = table.featurize(lambda: b["images"], b["indices"])
        np.testing.assert_array_equal(t.numpy(), a)
    assert len(table._table) >= len(table._row) == 5 * B


def test_trainer_cache_matches_uncached(vocabs, tmp_path):
    """Two epochs on image batches through the trainer with a fake encoder:
    the host and device caches train identically (their features are the
    same f16 values), and the encoder runs only in epoch 0."""
    jv, tv = vocabs
    V = len(jv)
    caps = next(feature_batches(V))["captions"]

    def batches(epoch):
        for b in image_batches(2):
            yield {**b, "captions": caps, "style_id": np.int32(4)}

    hist, calls = {}, {}
    for mode in ("host", "device"):
        cfg = tconfig.TrainConfig(max_epochs=2, batch_size=B, checkpoint_dir=str(tmp_path / mode),
                                  cache_features=mode == "host",
                                  cache_features_device=mode == "device")
        tt = tharness.CaptionTrainer(from_jax_params(jax_model("hypernet", V), device="cpu"),
                                     "hypernet", cfg, tv, encoder_params={"fake": 0},
                                     device="cpu")
        calls[mode] = []
        tt.feature_cache._encode = fake_encoder(calls[mode])
        hist[mode] = tt.fit(batches)
    assert calls["host"] == calls["device"] == [B, B]
    for e in (0, 1):
        assert hist["host"][e]["train_loss_epoch"] == hist["device"][e]["train_loss_epoch"]


# ----------------------------------------------------------------- loader
def test_batch_loader_keys_and_errors():
    batches = [{"captions": np.arange(6, dtype=np.int32).reshape(2, 3), "style": "humour",
                "features": torch.ones(2, 1)} for _ in range(3)]
    out = list(BatchLoader(iter(batches), device="cpu"))
    assert len(out) == 3
    assert isinstance(out[0]["captions"], torch.Tensor) and out[0]["style"] == "humour"
    np.testing.assert_array_equal(out[0]["captions"].numpy(), batches[0]["captions"])

    def broken():
        yield batches[0]
        raise ValueError("bad batch")

    it = iter(BatchLoader(broken(), device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)
    # a consumer that stops early ends the worker
    it = iter(BatchLoader(iter(batches * 10), device="cpu", prefetch=1))
    next(it)
    it.close()


# -------------------------------------------------------- config and data
def test_config_fields_and_defaults():
    for jcls, tcls in ((jconfig.ModelConfig, tconfig.ModelConfig),
                       (jconfig.TrainConfig, tconfig.TrainConfig),
                       (jconfig.DataConfig, tconfig.DataConfig)):
        jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcls)]
        assert tf == jf


@pytest.mark.parametrize("extra", ([], ["--fused-scan", "--bf16-compute", "--lr", "0.01",
                                        "--dedicated-style-tokens", "--hn-m", "7"]))
def test_parsed_flags_match(extra):
    from captionax.cli.common import make_parser as jmake_parser
    from captionax.cli.common import parse_configs as jparse
    from captionax_torch.cli.common import make_parser as tmake_parser
    from captionax_torch.cli.common import parse_configs as tparse

    argv = flags() + extra
    got = tparse(tmake_parser("t").parse_args(argv))
    ref = jparse(jmake_parser("j").parse_args(argv))
    for a, b in zip(got, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tmake_parser("t").parse_args(argv).device is None


def test_synthetic_images_byte_for_byte():
    for name in ("synthetic_0.jpg", "synthetic_7.jpg", "x.jpg"):
        for hw in ((224, 224), (64, 48)):
            a, b = tsynth.synthetic_image(name, hw), jsynth.synthetic_image(name, hw)
            assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("styled", (False, True))
@pytest.mark.parametrize("dedicated", (False, True))
def test_batch_stream_matches(vocabs, styled, dedicated):
    """splits, and a whole random-style stream over two epochs (captions,
    styles, style ids, indices, images), then a fixed-style stream."""
    jv, tv = vocabs
    lines = [c for _, c in jflickr.load_factual_captions(CAPTIONS)]
    assert lines == [c for _, c in tflickr.load_factual_captions(CAPTIONS)]
    jd = jsynth.synthetic_flickr_style(12, jv, 10, lines, styled_fixture=styled)
    td = tsynth.synthetic_flickr_style(12, tv, 10, lines, styled_fixture=styled)
    jd.dedicated_style_tokens = td.dedicated_style_tokens = dedicated
    assert len(td) == len(jd) == 12
    assert td.humour == jd.humour and td.romantic == jd.romantic and td.factual == jd.factual
    assert td.splits(seed=3) == jd.splits(seed=3)
    train, _, test = td.splits(seed=0)
    streams = []
    for d in (td, jd):
        s = []
        for epoch in range(2):
            s += list(d.batches(train, 2, style="random", seed=epoch))
        s += list(d.batches(test, 4, style="humour", seed=0, shuffle=False,
                            drop_remainder=False))
        streams.append(s)
    assert len(streams[0]) == len(streams[1]) > 2
    for a, b in zip(*streams):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
    assert {b["style"] for b in streams[0]} >= {"factual", "romantic"}


def test_styled_caption_files(tmp_path):
    p = tmp_path / "styled.txt"
    p.write_text("a dog runs\n a cat sleeps \n")
    assert tflickr.load_styled_captions(str(p)) == jflickr.load_styled_captions(str(p))


def test_glove_matrix_matches(vocabs, tmp_path):
    from captionax.cli.common import maybe_load_glove as jmaybe
    from captionax.core.config import DataConfig as JData
    from captionax.data.glove import glove_embedding_matrix as jglove
    from captionax_torch.cli.common import maybe_load_glove as tmaybe
    from captionax_torch.data.glove import glove_embedding_matrix as tglove

    jv, tv = vocabs
    words = sorted(jv.w2i)[::3]
    rs = np.random.RandomState(4)
    path = tmp_path / "glove.txt"
    path.write_text("".join(f"{w} " + " ".join(f"{x:.5f}" for x in rs.randn(6)) + "\n"
                            for w in words) + "short 1.0\n")
    for init in ("norm", "zeros", "random"):
        got = tglove(str(path), tv, 6, init=init, seed=3, device="cpu")
        ref = np.asarray(jglove(str(path), jv, 6, init=init, seed=3))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)
    params = from_jax_params(jax_model("hypernet", len(jv)), device="cpu")
    jparams = jax_model("hypernet", len(jv))
    jparams["decoder"]["embed"] = np.zeros((len(jv), E), np.float32)
    path16 = tmp_path / "glove16.txt"
    path16.write_text("".join(f"{w} " + " ".join(f"{x:.5f}" for x in rs.randn(E)) + "\n"
                              for w in words))
    tmaybe(params, tconfig.DataConfig(glove_path=str(path16)), tv, E)
    jmaybe(jparams, JData(glove_path=str(path16)), jv, E)
    assert np.array_equal(params["decoder"]["embed"].numpy(),
                          np.asarray(jparams["decoder"]["embed"]))


def test_runtime_helpers(tmp_path):
    from captionax_torch.core import runtime

    timer = runtime.StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop({"x": [torch.ones(2)]})
    summary = timer.summary()
    assert summary["steps"] == 3 and 0 <= summary["p50_ms"] <= summary["max_ms"]
    assert runtime.StepTimer().summary() == {}
    runtime.device_barrier({"a": [torch.zeros(1)]})
    assert runtime.device_time(lambda x: x + 1, torch.ones(8), k=2, iters=2) > 0
    assert runtime.host_rss_mb() > 0
    with runtime.trace(str(tmp_path / "t")) as d:
        torch.ones(4).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
