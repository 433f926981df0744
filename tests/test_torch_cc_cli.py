"""The port's Conceptual Captions CLIs on the CPU (``--device cpu``) at the
committed fixture's sizes (E=H=F=16, ``--hyper-emb 8 --hn-m 64``, the
fixture's caption file for the vocab, synthetic images, batches of 4,
``--max-len 10``, ``--beam-max-steps 8``), against captionax's CLIs on the
same files.

The seams: captionax's initial model (its builder in each CLI) is carried
into the port, and both trainers encode images with one fixed function in
place of the ResNet (the two encoders agree only to bf16 rounding, which
``test_torch_encoder.py`` holds; captionax's ResNet-50 would take ~20 s
of this file's time on the CPU).  Under them, every logged step's losses
agree within 1e-5 relative, and every other metric within 1e-6, in:
- ``cc_train_hypernet --domain-scheme "histograme log"`` for two epochs,
  then ``test_zero_shot`` on each package's own checkpoint;
- ``train_hyper_combine --style-aux --select-sep-margin`` (``one hot``, a
  4-class probe, two epochs: the style losses, ``val_sep_margin`` and
  ``val_sep_acc`` of the probe's decodes, the selected checkpoint's test),
  then ``test_all`` on each package's checkpoint (its five result sets);
- ``cc_train_gru`` (two epochs and its test) and ``train_cc`` without
  ``--fetch`` (two epochs).

Also against captionax:
- ``test_zero_shot`` after an ``one hot`` or ``embedding`` model: both
  packages raise at the restore (the zero-shot domains change the shapes);
- ``train_hyper_combine`` with a histogram or JSD scheme: both raise
  ``FileNotFoundError`` (the styles are zero-shot domains with no file);
- ``train_init`` from the same hypernet and targets: the distilled
  hypernet within rtol 1e-4, atol 1e-6 after 6 Adam steps;
- ``preprocess``: every subcommand's files byte for byte equal
  (``gcc-download`` over ``file://`` URLs), ``analyze-domains``' report
  equal; ``build_vocab``: the same words, each package reading the
  other's pickle.

The port alone: ``--init-hn`` from a ``.pkl``, and ``train_init`` ->
``train_hypernet --init-hn``."""

import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.cli import build_vocab as jbuild_vocab_cli
from captionax.cli import cc_train_gru as jcc_gru
from captionax.cli import cc_train_hypernet as jcc
from captionax.cli import common as jcommon
from captionax.cli import preprocess as jpre
from captionax.cli import test_all as jall
from captionax.cli import test_zero_shot as jzs
from captionax.cli import train_cc as jtrain_cc
from captionax.cli import train_hyper_combine as jcombine
from captionax.cli import train_init as jinit
from captionax.core.vocab import load_vocab_pickle as jload_vocab
from captionax.data import domains as jdomains
from captionax.models.classifiers import (
    classifier_ids_apply_fn,
    small_style_classifier_init,
    style_classifier_init,
)
from captionax.models.hypernet import hypernet_apply as jhypernet_apply
from captionax.models.hypernet import hypernet_init
from captionax.train import checkpoint as jckpt
from captionax.train import harness as jharness
from captionax_torch.cli import build_vocab as tbuild_vocab_cli
from captionax_torch.cli import cc_train_gru as tcc_gru
from captionax_torch.cli import cc_train_hypernet as tcc
from captionax_torch.cli import common as tcommon
from captionax_torch.cli import preprocess as tpre
from captionax_torch.cli import test_all as tall
from captionax_torch.cli import test_zero_shot as tzs
from captionax_torch.cli import train_cc as ttrain_cc
from captionax_torch.cli import train_hyper_combine as tcombine
from captionax_torch.cli import train_hypernet as thypernet
from captionax_torch.cli import train_init as tinit
from captionax_torch.core.vocab import load_vocab_pickle as tload_vocab
from captionax_torch.data import domains as tdomains
from captionax_torch.interop import from_jax_params
from captionax_torch.train import checkpoint as tckpt
from captionax_torch.train import harness as tharness
from captionax_torch.train.state import tree_leaves
from tests.fixtures.gru_fixture import CAPTIONS, flags

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
LOSS_RTOL = 1e-5
METRIC_TOL = 1e-6
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SEP = " " * 5
CC_DOMAINS = ("alamy", "dailymail", "wordpress", "pinimg")
ZERO_SHOT = ("istockphoto", "gettyimages")


def fixture_words():
    with open(CAPTIONS) as f:
        return sorted({w for line in f for w in line.split("\t", 1)[1].split()
                       if w.isalpha()})


def write_cc(path, domains, rows, seed):
    rs = np.random.RandomState(seed)
    words = fixture_words() + ["unknownword"]
    with open(path, "w") as f:
        for dom in domains:
            for i in range(rows):
                f.write(f"{dom}_{i}.jpg{SEP}{' '.join(rs.choice(words, rs.randint(4, 9)))}"
                        f"{SEP}{dom}\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cc_files")
    return {"cc": write_cc(tmp / "cc.txt", CC_DOMAINS, 12, 1),
            "oneshot": write_cc(tmp / "oneshot.txt", ZERO_SHOT, 5, 2)}


def cc_flags(files, ckdir, *extra):
    return flags(ckdir) + ["--hyper-emb", "8", "--hn-m", "64", "--max-epochs", "2",
                           "--log-every", "1", "--cc-captions", files["cc"],
                           "--cc-oneshot-captions", files["oneshot"], *extra]


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def all_finite(d):
    return all(np.isfinite(float(v)) for v in d.values())


# ------------------------------------------------------------------ the seams
PROJECTION = np.random.RandomState(0).randn(3, 2048).astype(np.float32)
NOT_COMPARED = {"_time", "epoch_seconds", "rss_mb"}


def stub_features(images) -> np.ndarray:
    """uint8 [B, 224, 224, 3] -> f32 [B, 49, 2048]: each 32x32 block's mean
    colour through a fixed projection, in place of the ResNet."""
    x = np.asarray(images, np.float32).reshape(len(images), 7, 32, 7, 32, 3)
    return np.abs(x.mean(axis=(2, 4)).reshape(len(images), 49, 3) / 255.0 @ PROJECTION)


TESTED = []  # each test_beam call's batches: (domain, domain value, captions)


def recorded(batches):
    """``batches``, each one's domain, domain value and captions kept in a
    new entry of TESTED."""
    rows = []
    TESTED.append(rows)
    for b in batches:
        rows.append((b.get("domain"), np.asarray(b.get("domain_value", -1)).tolist(),
                     np.asarray(b["captions"]).tolist()))
        yield b


class StubJTrainer(jharness.CaptionTrainer):
    """captionax's trainer on :func:`stub_features`; its tests recorded."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._encode = lambda _p, images: jnp.asarray(stub_features(images))
        if self.feature_cache is not None:
            self.feature_cache._encode = self._encode

    def test_beam(self, batches):
        return super().test_beam(recorded(batches))


class StubTTrainer(tharness.CaptionTrainer):
    """The port's trainer on :func:`stub_features`; its tests recorded."""

    def _encode(self, _params, images):
        return torch.from_numpy(stub_features(images)).to(self.device)

    def test_beam(self, batches):
        return super().test_beam(recorded(batches))


def stub_encoders(mp, jmod, tmod):
    """Both packages' CLI modules encode with :func:`stub_features`."""
    for mod, trainer in ((jmod, StubJTrainer), (tmod, StubTTrainer)):
        mp.setattr(mod, "CaptionTrainer", trainer)
        mp.setattr(mod, "build_encoder", lambda *_a, **_k: {})


def carry_initial(mp, jmod, tmod, builder: str, index=None):
    """captionax's ``builder`` in ``jmod`` keeps its first weights; the
    port's in ``tmod`` returns them, carried, in place of its own (of the
    same shapes).  ``index``: the weights' place in a tuple result."""
    made = {}
    real_j, real_t = getattr(jmod, builder), getattr(tmod, builder)

    def weights(out):
        return out if index is None else out[index]

    def captionax_build(*args, **kwargs):
        out = real_j(*args, **kwargs)
        made.setdefault("initial", jax.tree_util.tree_map(np.asarray, weights(out)))
        return out

    def port_build(*args, **kwargs):
        out = real_t(*args, **kwargs)
        carried = from_jax_params(made["initial"], "cpu")
        assert [tuple(x.shape) for x in tree_leaves(weights(out))] == [
            tuple(x.shape) for x in tree_leaves(carried)]
        return carried if index is None else out[:index] + (carried,) + out[index + 1:]

    mp.setattr(jmod, builder, captionax_build)
    mp.setattr(tmod, builder, port_build)


def run_both(tmp, *calls) -> dict:
    """Each ``(captionax main, port main, checkpoint dir -> argv)`` of
    ``calls`` in order, for each package in its own checkpoint dir (the
    port's with ``--device cpu``) -> {package: {"out": [return values],
    "log": run.jsonl's rows, "tested": TESTED, "dir": the checkpoint
    dir}}."""
    out = {}
    for side, name in enumerate(("captionax", "port")):
        d = str(tmp / name)
        TESTED.clear()
        res = [call[side](call[2](d) + (CPU if side else [])) for call in calls]
        out[name] = {"out": res, "log": read_log(os.path.join(d, "run.jsonl")),
                     "tested": list(TESTED), "dir": d}
    return out


def assert_agree(got: dict, ref: dict, what):
    """The same keys (bar times and memory); each loss within LOSS_RTOL
    relative, every other number within METRIC_TOL."""
    keys = set(ref) - NOT_COMPARED
    assert set(got) - NOT_COMPARED == keys, what
    for k in keys:
        tol = LOSS_RTOL * abs(ref[k]) if "loss" in k else METRIC_TOL
        assert abs(float(got[k]) - float(ref[k])) <= tol, (what, k, got[k], ref[k])


def assert_logs_agree(runs: dict) -> list:
    """Both run.jsonl's rows pairwise: every logged step's losses, every
    epoch's metrics, the test's.  -> the port's rows."""
    ref, got = runs["captionax"]["log"], runs["port"]["log"]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert_agree(a, b, i)
    return got


def train_rows(log) -> list:
    return [r for r in log if "train_loss" in r]


def metrics_of_test(log) -> dict:
    return {k[5:]: v for r in log for k, v in r.items() if k.startswith("test_")}


# ------------------------------------------- cc_train_hypernet, test_zero_shot
@pytest.fixture(scope="module")
def zero_shot_runs(files, tmp_path_factory):
    """Both packages' cc_train_hypernet then test_zero_shot on the same
    files, from the same weights, on the same features."""
    scheme = ["--domain-scheme", "histograme log", "--cache-features"]
    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jcc, tcc)
        stub_encoders(mp, jzs, tzs)
        carry_initial(mp, jcc, tcc, "build_cc_model_and_embedder", index=0)
        return run_both(tmp_path_factory.mktemp("zero_shot"),
                        (jcc.main, tcc.main, lambda d: cc_flags(files, d, *scheme)),
                        (jzs.main, tzs.main, lambda d: cc_flags(files, d, *scheme)))


def test_cc_train_hypernet_losses_match(zero_shot_runs):
    ref = [r["train_loss"] for r in train_rows(zero_shot_runs["captionax"]["log"])]
    got = [r["train_loss"] for r in train_rows(zero_shot_runs["port"]["log"])]
    assert len(got) == len(ref) == 16  # 4 domains x 2 batches, two epochs
    for i, (a, b) in enumerate(zip(got, ref)):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (i, a, b)
    hist = zero_shot_runs["port"]["out"][0]
    assert sorted(hist) == [0, 1] and all(all_finite(h) for h in hist.values())
    for k in ("val_loss_tf", "val_loss"):
        for e in (0, 1):
            ref_v = zero_shot_runs["captionax"]["out"][0][e][k]
            assert abs(hist[e][k] - ref_v) <= LOSS_RTOL * abs(ref_v), (e, k)


def test_cc_train_hypernet_test_metrics_match(zero_shot_runs):
    ref = metrics_of_test(zero_shot_runs["captionax"]["log"])
    got = metrics_of_test(zero_shot_runs["port"]["log"])
    assert set(got) == set(ref) and got["beam_completed"] > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_TOL, k


def test_test_zero_shot_matches(zero_shot_runs):
    ref, got = zero_shot_runs["captionax"]["out"][1], zero_shot_runs["port"]["out"][1]
    assert set(got) == set(ref) and all_finite(got)
    assert got["beam_completed"] == ref["beam_completed"] > 0
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_TOL, k


@pytest.mark.parametrize("scheme", ["one hot", "embedding"])
@pytest.mark.parametrize("package", ["captionax", "port"])
def test_test_zero_shot_raises_for_id_schemes(files, tmp_path, scheme, package):
    """A cc_train_hypernet model of an id scheme has no row for the unseen
    domains, so test_zero_shot's restore raises in both packages."""
    d = str(tmp_path / "ck")
    argv = cc_flags(files, d, "--domain-scheme", scheme)
    if package == "captionax":
        cfgs = jcc.parse_configs(jcc.make_parser("").parse_args(argv))
        vocab = jcc.resolve_vocab(cfgs[2])
        cfgs[0].vocab_size = len(vocab)
        params, _, _ = jcc.build_cc_model_and_embedder(cfgs[0], cfgs[2], vocab,
                                                       jax.random.PRNGKey(0))
        jckpt.save_checkpoint(d, 1, params)
        main = jzs.main
    else:
        argv = argv + CPU
        cfgs = tcc.parse_configs(tcc.make_parser("").parse_args(argv))
        vocab = tcc.resolve_vocab(cfgs[2])
        params, _, _ = tcc.build_cc_model_and_embedder(cfgs[0], cfgs[2], vocab,
                                                       torch.Generator(), device="cpu")
        tckpt.save_checkpoint(d, 1, params)
        main = tzs.main
    with pytest.raises(ValueError):
        main(argv)


# ------------------------------------------- train_hyper_combine, test_all
@pytest.mark.parametrize("scheme", ["histograme", "histograme log", "histograme tfidf", "JSD"])
@pytest.mark.parametrize("package", ["captionax", "port"])
def test_train_hyper_combine_mlp_schemes_raise(files, tmp_path, scheme, package):
    argv = cc_flags(files, str(tmp_path / "ck"), "--domain-scheme", scheme)
    main = jcombine.main if package == "captionax" else tcombine.main
    with pytest.raises(FileNotFoundError):
        main(argv + ([] if package == "captionax" else CPU))


@pytest.fixture(scope="module")
def probe4(files, tmp_path_factory):
    """A seeded 4-class small probe, pickled as captionax's numpy tree."""
    vocab = tcommon.resolve_vocab(tcommon.parse_configs(
        tcommon.make_parser("").parse_args(cc_flags(files, "x")))[2])
    params = jax.tree_util.tree_map(np.asarray, small_style_classifier_init(
        jax.random.PRNGKey(0), len(vocab), 16, 4))
    path = str(tmp_path_factory.mktemp("probe") / "probe4.pkl")
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return path


@pytest.fixture(scope="module")
def combined_runs(files, probe4, tmp_path_factory):
    """Both packages' train_hyper_combine --style-aux --select-sep-margin
    (``one hot``, two epochs) from the same weights, then test_all on each
    one's checkpoint, on the same features."""
    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jcombine, tcombine)
        stub_encoders(mp, jall, tall)
        carry_initial(mp, jcombine, tcombine, "build_hypernet_model")
        return run_both(
            tmp_path_factory.mktemp("combine"),
            (jcombine.main, tcombine.main, lambda d: cc_flags(
                files, d, "--style-aux", "--skip-val-quality", "--select-sep-margin",
                "--sep-probe-images", "4", "--style-classifier", probe4)),
            (jall.main, tall.main, lambda d: cc_flags(files, d)))


def test_train_hyper_combine_style_aux_select(combined_runs):
    """Every step's train, CE and style losses, each epoch's validation
    losses, val_sep_margin and val_sep_acc (the probe's decodes), and the
    selected checkpoint's test metrics equal captionax's."""
    logs = assert_logs_agree(combined_runs)
    hist = combined_runs["port"]["out"][0]
    assert sorted(hist) == [0, 1]
    for h in hist.values():
        assert all_finite(h) and 0.0 <= h["val_sep_margin"] <= 1.0 and "val_sep_acc" in h
    steps = train_rows(logs)
    assert steps and all(np.isfinite([r["train_loss"], r["ce_loss"], r["style_loss"]]).all()
                         for r in steps)
    assert metrics_of_test(logs)["beam_completed"] > 0
    tree = tckpt.restore_checkpoint(combined_runs["port"]["dir"])
    assert set(tree) == {"decoder", "hn", "domain_emb"} and tree["domain_emb"] == {}
    # one hot: the 100 CC ids, then the styles at ids 100-102
    assert tree["hn"]["base"]["l0"]["w"].shape[0] == 103


def test_test_all_five_sets(combined_runs):
    """The five result sets equal captionax's, and so does every tested
    batch (train_hyper_combine's test, then test_all's five): its domain,
    the domain value it is conditioned on, its captions, in order."""
    ref, got = combined_runs["captionax"]["out"][1], combined_runs["port"]["out"][1]
    assert list(got) == list(ref) == ["factual", "humour", "romantic", "cc", "cc_zero_shot"]
    tested = combined_runs["port"]["tested"]
    assert len(tested) == 6 and all(tested) and tested == combined_runs["captionax"]["tested"]
    # f/h/r at 100-102, the unseen CC domains past the trained width
    assert [{v for _, v, _ in t} for t in tested[1:4]] == [{100}, {101}, {102}]
    assert {v for _, v, _ in tested[5]} == {103, 104}
    for name in ref:
        assert all_finite(got[name]) and "beam_completed" in got[name]
        assert_agree(got[name], ref[name], name)


@pytest.mark.parametrize("steps", [20, 30])
@pytest.mark.parametrize("kind", ["small", "bert"])
def test_probe_decode_matches_captionax(files, monkeypatch, kind, steps):
    """The port's ``probe_decode`` against captionax's sep probe (its
    jitted ``_decode_probe``'s body, on captionax's functions) from the
    same weights, for a style and a CC conditioning: the theta handed to
    the beam search within 1e-6, and the probe's class probabilities
    within 1e-6 on the same decoded tokens.  The beam search returns given
    captions (one to the last step, one ending early, one not found), as
    the tiny models' own decodes end at once or find nothing, where no cut
    or offset of the probe's 25 tokens would show; ``steps`` 20 and 30
    fall short of and past those 25.  The BERT kind takes captionax's
    softmax of its output."""
    model_cfg, _, data_cfg = jcommon.parse_configs(
        jcommon.make_parser("").parse_args(cc_flags(files, "x")))
    vocab = jcommon.resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    kw = dict(hyper_emb=model_cfg.hyper_emb, zero_shot_domains=list("fhr"))
    jemb = jdomains.DomainEmbedder("one hot", vocab, list(CC_DOMAINS), **kw)
    temb = tdomains.DomainEmbedder("one hot", vocab, list(CC_DOMAINS), **kw)
    params = jcommon.build_hypernet_model(model_cfg, vocab, jax.random.PRNGKey(5),
                                          hyper_emb=jemb.hyper_emb)
    params["domain_emb"] = jemb.init_params(jax.random.PRNGKey(6))
    key = jax.random.PRNGKey(7)
    clf = (small_style_classifier_init(key, len(vocab), 16, 4) if kind == "small"
           else style_classifier_init(key, len(vocab), 4, hidden=32, num_layers=1))
    clf_apply = classifier_ids_apply_fn(clf)
    feats = np.random.RandomState(8).rand(3, 49, 2048).astype(np.float32)
    tokens = np.random.RandomState(9).randint(4, len(vocab), (3, steps + 1)).astype(np.int32)
    tokens[:, 0] = 0  # the start token
    tokens[0, -1] = 2  # </s> at the last step
    tokens[1, 6], tokens[1, 7:] = 2, 0  # </s> at step 6, then padding
    tokens[2] = 0  # nothing found
    probe_t = 25

    def reference(domain_value):
        theta = jhypernet_apply(params["hn"], jemb.embed(params["domain_emb"], domain_value))
        ids = jnp.asarray(tokens)  # the beam search's .tokens
        padded = jnp.zeros((ids.shape[0], probe_t), jnp.int32)
        padded = padded.at[:, : min(probe_t, ids.shape[1] - 1)].set(ids[:, 1:][:, :probe_t])
        out = clf_apply(clf, padded)
        return theta, np.asarray(out if "bert" not in clf else jax.nn.softmax(out, axis=-1))

    seen = {}

    def searching(decoder, features, k, max_steps, gru_params, device):
        assert (k, max_steps) == (3, steps) and torch.equal(features, torch.from_numpy(feats))
        seen["theta"] = gru_params
        return types.SimpleNamespace(tokens=torch.from_numpy(tokens))

    monkeypatch.setattr(tcombine, "beam_search", searching)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tclf = from_jax_params(jax.tree_util.tree_map(np.asarray, clf), "cpu")
    for dom in ("f", "h", "alamy"):
        value = np.asarray(jemb.host_vector(dom))
        theta, ref = reference(jnp.asarray(value))
        got = tcombine.probe_decode(tparams, temb, torch.from_numpy(feats),
                                    torch.as_tensor(value), tclf, 3, steps, "cpu")
        for a, b in zip(tree_leaves(seen["theta"]), jax.tree_util.tree_leaves(theta)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=METRIC_TOL)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=METRIC_TOL, err_msg=dom)


def test_train_hyper_combine_init_hn_pkl(files, tmp_path, monkeypatch):
    """--init-hn x.pkl with {'hn': numpy tree}, as captionax writes it."""
    hn = jax.tree_util.tree_map(np.asarray, hypernet_init(
        jax.random.PRNGKey(4), hyper_emb=103, input_dim=32, hidden_dim=16, M=64))
    path = str(tmp_path / "hn.pkl")
    with open(path, "wb") as f:
        pickle.dump({"hn": hn}, f)
    seen = {}

    class Spy(StubTTrainer):
        def __init__(self, params, *a, **kw):
            seen["hn"] = params["hn"]
            super().__init__(params, *a, **kw)

    monkeypatch.setattr(tcombine, "CaptionTrainer", Spy)
    monkeypatch.setattr(tcombine, "build_encoder", lambda *_a, **_k: {})
    tcombine.main(cc_flags(files, str(tmp_path / "ck"), "--max-epochs", "0",
                           "--init-hn", path, *CPU))
    got = tree_leaves(seen["hn"])
    ref = jax.tree_util.tree_leaves(hn)
    assert len(got) == len(ref) and all(
        torch.equal(a, torch.from_numpy(np.array(b))) for a, b in zip(got, ref))


# ------------------------------------------------------ cc_train_gru, train_cc
@pytest.fixture(scope="module")
def gru_runs(files, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jcc_gru, tcc_gru)
        carry_initial(mp, jcc_gru, tcc_gru, "build_captioner")
        return run_both(tmp_path_factory.mktemp("cc_gru"),
                        (jcc_gru.main, tcc_gru.main, lambda d: cc_flags(files, d)))


def test_cc_train_gru(gru_runs):
    """Every step's loss, each epoch's validation and the test metrics
    equal captionax's; the checkpoint is written."""
    logs = assert_logs_agree(gru_runs)
    assert len(train_rows(logs)) == 16  # 4 domains x 2 batches, two epochs
    hist = gru_runs["port"]["out"][0]
    assert sorted(hist) == [0, 1] and all(all_finite(h) for h in hist.values())
    assert tckpt.latest_step(gru_runs["port"]["dir"]) is not None
    res = metrics_of_test(logs)
    assert res and all_finite(res) and res["beam_completed"] > 0
    assert gru_runs["port"]["tested"] == gru_runs["captionax"]["tested"]


@pytest.fixture(scope="module")
def train_cc_runs(files, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cc")
    tsv = tmp / "gcc.tsv"
    rs = np.random.RandomState(6)
    words = fixture_words()
    tsv.write_text("".join(f"{' '.join(rs.choice(words, rs.randint(4, 9)))}\t"
                           f"http://www.{s}.com/{i}.jpg\n"
                           for i, s in enumerate(["alamy", "dailymail", "pinimg"] * 8
                                                 + ["example"] * 2)))
    with pytest.MonkeyPatch.context() as mp:
        stub_encoders(mp, jtrain_cc, ttrain_cc)
        carry_initial(mp, jtrain_cc, ttrain_cc, "build_hypernet_model")
        return run_both(tmp, (jtrain_cc.main, ttrain_cc.main,
                              lambda d: cc_flags(files, d, "--gcc-tsv", str(tsv))))


def test_train_cc_without_fetch(train_cc_runs):
    """No --fetch: every image is the placeholder; the domains are the
    nine sites' one-hot ids.  Every step's loss and each epoch's mean
    equal captionax's."""
    logs = assert_logs_agree(train_cc_runs)
    assert len(train_rows(logs)) == 12  # 3 sites (example.com is none) x 2 batches, two epochs
    ref, got = train_cc_runs["captionax"]["out"][0], train_cc_runs["port"]["out"][0]
    assert sorted(got) == [0, 1]
    for e in got:
        assert all_finite(got[e])
        assert_agree(got[e], ref[e], e)


# ----------------------------------------------------------- train_init
def test_train_init_matches_captionax(files, tmp_path, monkeypatch):
    """The same hypernet and the same three target GRUs (captionax's,
    carried in call order): the distilled hypernet after 6 steps of plain
    Adam within rtol 1e-4, atol 1e-6 of optax.adam's."""
    made = {"hn": None, "targets": []}
    real_hn, real_cap = jinit.build_hypernet_model, jinit.build_captioner

    def jhn(*a, **k):
        out = real_hn(*a, **k)
        made["hn"] = jax.tree_util.tree_map(np.asarray, out)
        return out

    def jcap(*a, **k):
        out = real_cap(*a, **k)
        made["targets"].append(jax.tree_util.tree_map(np.asarray, out))
        return out

    calls = iter(range(3))
    monkeypatch.setattr(jinit, "build_hypernet_model", jhn)
    monkeypatch.setattr(jinit, "build_captioner", jcap)
    monkeypatch.setattr(tinit, "build_hypernet_model",
                        lambda *a, device=None, **k: from_jax_params(made["hn"], device))
    monkeypatch.setattr(tinit, "build_captioner",
                        lambda *a: from_jax_params(made["targets"][next(calls)], "cpu"))
    argv = cc_flags(files, str(tmp_path / "j"), "--max-steps", "6")
    ref = jinit.main(argv)
    got = tinit.main(cc_flags(files, str(tmp_path / "t"), "--max-steps", "6", *CPU))
    ref_hn, got_hn = jax.tree_util.tree_leaves(ref["hn"]), tree_leaves(got["hn"])
    assert len(ref_hn) == len(got_hn)
    for a, b in zip(got_hn, ref_hn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL)
    saved = tckpt.restore_checkpoint(str(tmp_path / "t"))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(saved["hn"]), got_hn))


def test_train_init_then_init_hn(files, tmp_path, monkeypatch):
    src = str(tmp_path / "init")
    distilled = tinit.main(cc_flags(files, src, "--max-steps", "20", *CPU))
    seen = {}

    class Spy(tharness.CaptionTrainer):
        def __init__(self, params, *a, **kw):
            seen["params"] = params
            super().__init__(params, *a, **kw)

    monkeypatch.setattr(thypernet, "CaptionTrainer", Spy)
    thypernet.main(cc_flags(files, str(tmp_path / "hn"), "--max-epochs", "0",
                            "--init-hn", src, *CPU))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(seen["params"]["hn"]),
                                                 tree_leaves(distilled["hn"])))


# ------------------------------------------------- preprocess, build_vocab
def preprocess_inputs(tmp):
    """Every subcommand's inputs, and its flags -> [output files]."""
    from PIL import Image

    styled = tmp / "styled_names.txt"
    styled.write_text("\n".join(f"img{i}.jpg" for i in (0, 2, 3, 5, 7, 11)) + "\n")
    humour = tmp / "humour.txt"
    humour.write_text("".join(f"a funny line {i}\n" for i in range(12)))
    romantic = tmp / "romantic.txt"
    romantic.write_text("".join(f"a loving line {i}\n" for i in range(12)))
    cc = write_cc(tmp / "cc.txt", CC_DOMAINS + ZERO_SHOT, 6, 5)
    hosts = ["http://www.alamy.com/", "https://i.dailymail.co.uk/", "http://a.pinimg.com/"]
    (tmp / "gcc.tsv").write_text("".join(f"caption number {i}\t{hosts[i % 3]}{i}.jpg\n"
                                         for i in range(20))
                                 + "no url here\nrare\thttp://www.rare.net/0.jpg\n")
    img_dir = tmp / "web"
    img_dir.mkdir()
    rs = np.random.RandomState(0)
    manifest, caps = [], []
    for i, dom in enumerate(["alamy"] * 3 + ["dailymail"] * 2 + ["pinimg"] * 2):
        src = img_dir / f"src{i}.png"
        arr = rs.randint(0, 256, (20 + i, 24, 3), np.uint8)
        Image.fromarray(arr[..., 0] if i == 2 else arr).save(src)
        url = src.as_uri() if dom != "pinimg" else (img_dir / "missing.png").as_uri()
        if i == 4:
            (img_dir / "broken.png").write_bytes(b"not an image")
            url = (img_dir / "broken.png").as_uri()
        manifest.append(f"{i}.jpg\t{url}")
        caps.append(f"{i}.jpg{SEP}caption {i}{SEP}{dom}")
    (tmp / "m.urls").write_text("\n".join(manifest) + "\n")
    (tmp / "m.txt").write_text("\n".join(caps) + "\n")
    return {
        "flickr-select": (["--factual", CAPTIONS, "--styled-names", str(styled),
                           "--num-test", "3", "--seed", "2", "--out", "{o}/sel.txt"],
                          ["sel.txt", "sel.txt.test"]),
        "cc-split": (["--captions", cc, "--out-prefix", "{o}/cc", "--seed", "3"],
                     ["cc_train.txt", "cc_val.txt", "cc_test.txt"]),
        "merge-all": (["--cc", cc, "--factual", CAPTIONS, "--humour", str(humour),
                       "--romantic", str(romantic), "--seed", "4", "--out", "{o}/all.txt"],
                      ["all.txt"]),
        "gcc-select": (["--tsv", str(tmp / "gcc.tsv"), "--per-domain", "5",
                        "--min-per-domain", "3", "--out", "{o}/g.txt"], ["g.txt", "g.txt.urls"]),
        "gcc-download": (["--manifest", str(tmp / "m.urls"), "--captions", str(tmp / "m.txt"),
                          "--filtered-out", "{o}/kept.txt", "--workers", "2",
                          "--max-bad-per-domain", "1", "--out-dir", "{o}/images"],
                         ["kept.txt"] + [f"images/{i}.jpg" for i in (0, 1, 2, 3)]),
        "shuffle": (["--infile", cc, "--seed", "6", "--out", "{o}/shuf.txt"], ["shuf.txt"]),
        "analyze-domains": (["--captions", cc, "--top", "3"], []),
    }


@pytest.fixture(scope="module")
def preprocess_cases(tmp_path_factory):
    return preprocess_inputs(tmp_path_factory.mktemp("pre"))


@pytest.mark.parametrize("cmd", ["flickr-select", "cc-split", "merge-all", "gcc-select",
                                 "gcc-download", "shuffle", "analyze-domains"])
def test_preprocess_bytes_equal(preprocess_cases, tmp_path, capsys, cmd):
    argv, outputs = preprocess_cases[cmd]
    printed = {}
    for name, main in (("captionax", jpre.main), ("port", tpre.main)):
        o = tmp_path / name
        o.mkdir()
        main([cmd] + [a.format(o=o) for a in argv])
        printed[name] = capsys.readouterr().out.replace(str(o), "<out>")
    assert printed["port"] == printed["captionax"]
    for rel in outputs:
        got = (tmp_path / "port" / rel).read_bytes()
        assert got == (tmp_path / "captionax" / rel).read_bytes(), rel
        assert got
    if cmd == "gcc-download":
        assert sorted(os.listdir(tmp_path / "port" / "images")) == [
            f"{i}.jpg" for i in (0, 1, 2, 3)]
        # pinimg: every download failed, more than the allowed 1 -> dropped
        assert "pinimg" not in (tmp_path / "port" / "kept.txt").read_text()


@pytest.mark.parametrize("corpus", ["cc", "flickr"])
def test_build_vocab_and_pickles_cross_read(files, tmp_path, corpus):
    humour = tmp_path / "h.txt"
    humour.write_text("a funny dog\na silly cat\n")
    argv = (["--cc", files["cc"]] if corpus == "cc"
            else ["--factual", CAPTIONS, "--humour", str(humour), "--min-count", "3"])
    ref = jbuild_vocab_cli.main(argv + ["--out", str(tmp_path / "j.pkl")])
    got = tbuild_vocab_cli.main(argv + ["--out", str(tmp_path / "t.pkl")])
    assert got.w2i == ref.w2i and got.i2w == ref.i2w and len(got) > 7
    assert tload_vocab(str(tmp_path / "j.pkl")).w2i == ref.w2i
    assert jload_vocab(str(tmp_path / "t.pkl")).w2i == ref.w2i
