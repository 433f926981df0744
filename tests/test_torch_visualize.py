"""The port's HTML visualizer (captionax_torch/cli/visualize.py) on the CPU.

First tests/test_cli_smoke.py's two visualize smokes on the port, with its
TINY flags plus ``--device cpu``: a random-init report, and ``--kind gru``
on a ``train_gru`` checkpoint (one column, no style columns).

Then the port's report against captionax's ``visualize.main``, byte for
byte, in its three branches: the hypernet (one column per style),
``--kind gru`` (a bare captioner) and ``--dataset cc`` (one row per
domain, the theta from the ``histograme log`` embedder).  Both read the
same weights: captionax's checkpoint is written by captionax, the port's
holds the same params carried by ``from_jax_params``, and both fold one
``--encoder-weights`` state dict (ResNet-50, BN statistics drawn from a
seed).  The decoder weights are shaped as tests/test_torch_caption_cli.py
shapes its greedy set (fc x10, +1.0 on ``</s>``, the feature MLP and
init_h x10), so that the greedy captions depend on the image; the test
checks that they do.  Both encoders run in f32 here (captionax's
``encoder_cnn`` and the port's ``CNNEncoder`` under ``make_encoder``, each
at ``compute_dtype`` f32): in bf16 they round at other points (captionax
after each conv, the port's K4 route once per conv), and on these weights
that flipped a near tie in 2 of the hypernet branch's 12 greedy captions.
tests/test_torch_encoder.py holds the bf16 encoders to each other.  Last,
``visualize`` runs on the card by default."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.cli import cc_train_hypernet as jcc
from captionax.cli import common as jcommon
from captionax.cli import visualize as jviz
from captionax.models.encoder import encoder_cnn
from captionax.train.checkpoint import save_checkpoint as jsave
from captionax_torch.cli import train_gru as ttrain_gru
from captionax_torch.cli import visualize as tviz
from captionax_torch.data.cc import SEP
from captionax_torch.interop import from_jax_params
from captionax_torch.models import encoder as tenc
from captionax_torch.train.checkpoint import save_checkpoint as tsave
from tests.fixtures.gru_fixture import CAPTIONS
from tests.test_torch_caption_cli import WEIGHTS, _state_dict

torch.set_num_threads(1)
TINY = [
    "--synthetic", "--synthetic-images", "8", "--batch-size", "4",
    "--max-epochs", "1", "--encoder-depth", "50",
    "--embed-size", "16", "--hidden-size", "16", "--feature-size", "16",
    "--hyper-emb", "8", "--hn-m", "64",
    "--max-len", "8", "--beam-max-steps", "6",
]
CPU = ["--device", "cpu"]
N_IMAGES = 4
CC_DOMAINS = ("alamy", "dailymail", "wordpress")


def _flags(tmp_path, *extra):
    return TINY + CPU + ["--checkpoint-dir", str(tmp_path / "ckpt"), *extra]


# ------------------------------------------------ tests/test_cli_smoke.py's
def test_visualize_random_init(tmp_path):
    out = tmp_path / "viz.html"
    assert tviz.main(_flags(tmp_path, "--out", str(out), "--num-images", "2")) == str(out)
    html = out.read_text()
    assert "<html" in html.lower() and "img" in html.lower()
    assert html.count("<tr>") == 3 and "<b>humour</b>" in html


def test_visualize_gru_checkpoint(tmp_path, capsys):
    ttrain_gru.main(_flags(tmp_path))
    out = tmp_path / "viz_gru.html"
    tviz.main(_flags(tmp_path, "--out", str(out), "--num-images", "2", "--kind", "gru"))
    assert "loaded checkpoint" in capsys.readouterr().out
    html = out.read_text()
    assert "<html" in html.lower() and "factual" in html
    assert "humour" not in html  # plain captioner has no style columns


# ------------------------------------------------------ against captionax
def _shape(decoder):
    """WEIGHTS["greedy"] on a captioner tree (numpy, in place)."""
    bias, fc_scale, feat_scale = WEIGHTS["greedy"]
    decoder["fc"]["w"] = decoder["fc"]["w"] * fc_scale
    decoder["fc"]["b"][2] += bias
    decoder["feature_fc"]["l0"]["w"] = decoder["feature_fc"]["l0"]["w"] * feat_scale
    decoder["init_h"]["w"] = decoder["init_h"]["w"] * feat_scale


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The encoder weights, a CC caption file and, per branch, captionax's
    checkpoint and the port's of the same params."""
    root = tmp_path_factory.mktemp("visualize_corpus")
    torch.save(_state_dict(6), root / "encoder.pt")
    with open(CAPTIONS) as f:
        lines = [line.split("\t", 1)[1].strip() for line in f if "\t" in line]
    (root / "cc.txt").write_text("".join(
        f"{d}_{i}.jpg{SEP}{lines[(3 * d + i) % len(lines)]}{SEP}{dom}\n"
        for d, dom in enumerate(CC_DOMAINS) for i in range(3)))
    flags = [a for a in TINY if a != "--synthetic"] + [
        "--synthetic", "--factual-captions", CAPTIONS,
        "--vocab-path", str(root / "no_such_vocab.pkl"),
        "--encoder-weights", str(root / "encoder.pt"),
        "--cc-captions", str(root / "cc.txt"), "--domain-scheme", "histograme log",
        "--num-images", str(N_IMAGES)]
    model_cfg, _, data_cfg = jcommon.parse_configs(jcommon.make_parser("corpus").parse_known_args(
        flags)[0])
    vocab = jcommon.resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    key = jax.random.PRNGKey(7)
    trees = {
        "hypernet": jcommon.build_hypernet_model(model_cfg, vocab, key),
        "gru": jcommon.build_captioner(model_cfg, vocab, key),
        "cc": jcc.build_cc_model_and_embedder(model_cfg, data_cfg, vocab, key)[0],
    }
    for name, tree in trees.items():
        params = jax.tree_util.tree_map(np.array, tree)
        _shape(params if name == "gru" else params["decoder"])
        jsave(str(root / f"jax_{name}"), 1, params)
        tsave(str(root / f"port_{name}"), 1, from_jax_params(params, device="cpu"))
    return root, flags


BRANCHES = {"hypernet": [], "gru": ["--kind", "gru"], "cc": ["--dataset", "cc"]}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_html_matches_captionax_byte_for_byte(corpus, branch, monkeypatch):
    root, flags = corpus
    monkeypatch.setattr(jviz, "encoder_cnn",
                        lambda params, images: encoder_cnn(params, images, jnp.float32))
    monkeypatch.setattr(tenc, "CNNEncoder",
                        functools.partial(tenc.CNNEncoder, compute_dtype=torch.float32))
    extra = BRANCHES[branch]
    ref, got = root / f"{branch}_jax.html", root / f"{branch}_port.html"
    jviz.main(flags + extra + ["--checkpoint-dir", str(root / f"jax_{branch}"),
                               "--out", str(ref)])
    tviz.main(flags + extra + CPU + ["--checkpoint-dir", str(root / f"port_{branch}"),
                                     "--out", str(got)])
    want = ref.read_bytes()
    assert got.read_bytes() == want
    rows = re.findall(r"<tr>(.*?)</tr>", want.decode())
    cells = [re.findall(r"<td[^>]*>(.*?)</td>", r) for r in rows]
    n_rows = len(CC_DOMAINS) if branch == "cc" else N_IMAGES
    n_cols = {"hypernet": 5, "gru": 3, "cc": 4}[branch]
    assert len(cells) == 1 + n_rows and all(len(c) == n_cols for c in cells)
    assert all(c[0].startswith("<img src='data:image/png;base64,") for c in cells[1:])
    predicted = [c[1 if branch != "cc" else 2] for c in cells[1:]]
    assert all(predicted) and len(set(predicted)) > 1  # the captions depend on the image


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviz.main(TINY + ["--checkpoint-dir", str(tmp_path), "--out", str(tmp_path / "v.html")])
