"""The port's training CLIs on the CPU, end to end, at the committed
fixture's sizes (E=H=F=16, ResNet-50, 12 synthetic images, --max-len 10,
--beam-max-steps 8): ``train_gru`` then ``evaluate`` on its checkpoint,
``train_hypernet`` (plain, dedicated style tokens, bf16 on the K3 route,
warm-started with ``--init-hn``), the options that are not ported yet (and
the style losses without their classifier), and the default device.  Then the committed captionax checkpoint
``tests/fixtures/gru_ckpt``, restored with captionax and carried into the
port's checkpoint format: the port's ``beam_search`` and ``greedy`` on
captionax's encoder features reproduce ``tests/fixtures/gru_goldens.json``'s
tokens exactly, and the port's ``test_beam`` its metrics within 1e-6."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from captionax.train.checkpoint import latest_step as jlatest_step
from captionax_torch.cli import evaluate, train_gru, train_hypernet
from captionax_torch.core import config as tconfig
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.core.vocab import extract_factual_caption_lines as textract
from captionax_torch.decode import search as tsearch
from captionax_torch.interop import from_jax_params
from captionax_torch.train import checkpoint as tckpt
from captionax_torch.train import harness as tharness
from captionax_torch.train.state import tree_leaves
from tests.fixtures.gru_fixture import CAPTIONS, CKPT_DIR, GOLDENS, flags

torch.set_num_threads(1)
METRIC_TOL = 1e-6
CPU = ["--device", "cpu", "--cache-features"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def logged_tests(path, prefix):
    """The test results a CLI logged: {metric: value} of the record whose
    keys start with ``prefix``."""
    recs = [r for r in read_log(path) if any(k.startswith(prefix) for k in r)]
    assert len(recs) == 1
    return {k[len(prefix):]: v for k, v in recs[0].items() if k.startswith(prefix)}


def all_finite(d):
    return all(math.isfinite(float(v)) for v in d.values())


# ------------------------------------------------------------------- CLIs
def test_train_gru_then_evaluate(tmp_path):
    """The checkpoint is the last step's (the validation loss fell in both
    epochs), so evaluate's beam test repeats the training CLI's own."""
    d = str(tmp_path / "gru")
    hist = train_gru.main(flags(d) + CPU + ["--max-epochs", "2"])
    assert sorted(hist) == [0, 1] and all(all_finite(h) for h in hist.values())
    steps = [r["step"] for r in read_log(os.path.join(d, "run.jsonl")) if "epoch" in r]
    assert tckpt.latest_step(d) == steps[-1] == 4  # 9 train images, batches of 4
    trained = logged_tests(os.path.join(d, "run.jsonl"), "test_")
    results = evaluate.main(flags(d) + CPU + ["--kind", "gru", "--styles", "factual"])
    assert set(results) == {"factual"}
    got = results["factual"]
    assert set(got) == set(trained)
    for k in trained:
        assert abs(float(got[k]) - trained[k]) <= 1e-9, k
    assert read_log(os.path.join(d, "run_eval.jsonl")) is not None


HYPERNET_CASES = {
    "plain": [],
    "dedicated_style_tokens": ["--dedicated-style-tokens"],
    "fused_bf16": ["--fused-scan", "--bf16-compute"],
}


@pytest.mark.parametrize("case", sorted(HYPERNET_CASES))
def test_train_hypernet(tmp_path, case):
    d = str(tmp_path / case)
    extra = HYPERNET_CASES[case]
    hist = train_hypernet.main(flags(d) + CPU + ["--max-epochs", "1"] + extra)
    assert all_finite(hist[0])
    log = os.path.join(d, "run.jsonl")
    for style in ("factual", "humour", "romantic"):
        res = logged_tests(log, f"test_{style}_")
        assert all_finite(res) and "beam_completed" in res
    tree = tckpt.restore_checkpoint(d)
    assert set(tree) == ({"decoder", "hn", "style_embed"} if extra[:1] == ["--dedicated-style-tokens"]
                         else {"decoder", "hn"})
    if case == "dedicated_style_tokens":
        assert tuple(tree["style_embed"].shape) == (3, 16)
        results = evaluate.main(flags(d) + CPU + extra + ["--kind", "hypernet"])
        assert set(results) == {"factual", "humour", "romantic"}
        assert all(all_finite(r) for r in results.values())


def test_train_hypernet_init_hn(tmp_path, monkeypatch):
    """--init-hn takes the hn subtree of a port checkpoint; the decoder keeps
    this run's init."""
    src = str(tmp_path / "src")
    train_hypernet.main(flags(src) + CPU + ["--max-epochs", "1", "--seed", "5"])
    donor = tckpt.restore_checkpoint(src)
    seen = {}

    class Spy(tharness.CaptionTrainer):
        def __init__(self, params, *a, **kw):
            seen["params"] = params
            super().__init__(params, *a, **kw)

    monkeypatch.setattr(train_hypernet, "CaptionTrainer", Spy)
    train_hypernet.main(flags(str(tmp_path / "dst")) + CPU
                        + ["--max-epochs", "0", "--init-hn", src])
    got = seen["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["hn"]), tree_leaves(donor["hn"])))
    assert not torch.equal(got["decoder"]["embed"], donor["decoder"]["embed"])


RAISES = {
    "mesh_gru": (train_gru, ["--mesh-data", "2"], NotImplementedError, "Parallelism"),
    "mesh_hypernet": (train_hypernet, ["--mesh-data", "2"], NotImplementedError,
                      "Parallelism"),
    "mesh_evaluate": (evaluate, ["--mesh-data", "2"], NotImplementedError, "Parallelism"),
    # the style losses are ported: without their classifier they raise
    "mixup": (train_hypernet, ["--mixup"], SystemExit, "--style-classifier"),
    "style_aux": (train_hypernet, ["--style-aux"], SystemExit, "--style-classifier"),
    "style_classifier": (train_hypernet, ["--mixup", "--style-classifier", "no_clf.pkl"],
                         FileNotFoundError, "no_clf.pkl"),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_unported_options_raise(tmp_path, case):
    cli, extra, exc, match = RAISES[case]
    with pytest.raises(exc, match=match):
        cli.main(flags(str(tmp_path)) + CPU + extra)


@pytest.mark.parametrize("cli", (train_gru, train_hypernet, evaluate))
def test_default_device_is_the_card(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(flags(str(tmp_path)))


# ---------------------------------------------------------------- goldens
@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """The committed captionax checkpoint restored with captionax, carried
    into the port's format and restored from it; captionax's encoder
    features of the fixture's test split (factual batches)."""
    from captionax.cli.common import (build_captioner, build_encoder, make_parser,
                                      parse_configs, resolve_flickr_data, resolve_vocab)
    from captionax.data.transforms import preprocess_images
    from captionax.models.encoder import encoder_cnn
    from captionax.train.checkpoint import restore_checkpoint

    args = make_parser("fixture").parse_args(flags())
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = restore_checkpoint(train_cfg.checkpoint_dir, like=build_captioner(model_cfg,
                                                                               vocab, k1))
    encoder = build_encoder(model_cfg, k2)
    _, _, test_idx = data.splits(seed=train_cfg.seed)
    encode = jax.jit(lambda p, x: encoder_cnn(p, preprocess_images(x)))
    batches = []
    for b in data.batches(test_idx, train_cfg.batch_size, style="factual", seed=0,
                          shuffle=False, drop_remainder=False):
        feats = np.array(encode(encoder, b["images"]))
        batches.append({"features": feats, "captions": b["captions"]})
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    tckpt.save_checkpoint(d, jlatest_step(CKPT_DIR), from_jax_params(np_tree(params),
                                                                     device="cpu"))
    like = from_jax_params(np_tree(params), device="cpu")
    port = tckpt.restore_checkpoint(d, like=like)
    tvocab = tbuild_vocab(textract(CAPTIONS))
    return port, batches, tvocab, train_cfg


def test_goldens_tokens_through_the_port_format(fixture_run):
    port, batches, _, cfg = fixture_run
    with open(GOLDENS) as f:
        goldens = json.load(f)
    beam_out, greedy_out = [], []
    for b in batches:
        feats = torch.from_numpy(b["features"])
        res = tsearch.beam_search(port, feats, k=cfg.beam_size, max_steps=cfg.beam_max_steps,
                                  device="cpu")
        for toks, n, found in zip(res.tokens.numpy(), res.lengths.numpy(), res.found.numpy()):
            beam_out.append([int(x) for x in toks[:n]] if found else [])
        gids = tsearch.greedy(port, feats, max_len=cfg.max_len, device="cpu").numpy()
        greedy_out.extend([[int(x) for x in row] for row in gids])
    assert beam_out == goldens["beam_tokens"]
    assert greedy_out == goldens["greedy_tokens"]


def test_goldens_metrics_through_test_beam(fixture_run, tmp_path):
    port, batches, tvocab, cfg = fixture_run
    with open(GOLDENS) as f:
        goldens = json.load(f)
    tcfg = tconfig.TrainConfig(checkpoint_dir=str(tmp_path), max_len=cfg.max_len,
                               beam_max_steps=cfg.beam_max_steps, batch_size=cfg.batch_size)
    tt = tharness.CaptionTrainer(port, "gru", tcfg, tvocab, device="cpu")
    got = tt.test_beam(iter(batches))
    for k, v in goldens["metrics"].items():
        assert abs(float(got[k]) - v) < METRIC_TOL, (k, got[k], v)
