"""The port's train_classifier CLI, and train_hypernet's style losses, on
the CPU against captionax's CLIs, at the committed fixture's sizes
(E=H=F=16, the fixture's caption file, 24 synthetic images, batches of 4,
--max-len 10; BERT trunks at hidden 32, 2 layers).

Both packages' classifier inits are patched in the test (captionax's
module attribute and the port's) to return the same weights, so the two
CLIs train from one init on the same data order: the held-out accuracy
must be equal, and the saved params within rtol 1e-4, atol 5e-4 (the
largest measured difference is 1.5e-4), their median difference within
1e-5.  The attention key biases are held to 2 * lr a step: their exact
gradient is 0 (softmax ignores a shift shared by every key), so Adam,
which moves an element by about lr a step whatever its gradient's size,
moves them by float noise, either way in each package.  Each package's
saved pickle is read by the other's train_hypernet."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.cli import train_classifier as jcli
from captionax.cli import train_hypernet as jhyper
from captionax.models import classifiers as jclf
from captionax_torch.cli import train_classifier as tcli
from captionax_torch.cli import train_hypernet as thyper
from captionax_torch.interop import from_jax_params
from captionax_torch.train import harness as tharness
from captionax_torch.train.state import tree_leaves
from tests.fixtures.gru_fixture import flags

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
LR = 5e-3
EPOCHS = 1
BERT = ["--bert-hidden", "32", "--bert-layers", "2"]
INITS = {"small": "small_style_classifier_init", "style3": "style_classifier_init",
         "style4": "style_classifier_init", "domain": "style_classifier_init",
         "essence": "essence_classifier_init"}


def cc_file(path):
    """A small CC caption file: three domains of eight rows."""
    sep = " " * 5
    with open(path, "w") as f:
        for d, dom in enumerate(("alamy", "dailymail", "wordpress")):
            for i in range(8):
                f.write(f"{d}_{i}.jpg{sep}a small {dom} test caption number {i}{sep}{dom}\n")
    return str(path)


def classifier_flags(tmp_path, kind, save):
    return (flags(str(tmp_path / "ck")) + BERT
            + ["--synthetic-images", "24", "--kind", kind, "--max-epochs", str(EPOCHS),
               "--lr", str(LR), "--cc-captions", cc_file(tmp_path / "cc.txt"),
               "--save", save, "--log-every", "2"])


def same_init(monkeypatch, kind):
    """Patch both CLIs' init of ``kind`` to captionax's init at PRNGKey(3),
    the port's carried over with from_jax_params."""
    name = INITS[kind]
    ref_init = getattr(jclf, name)
    made = {}

    def numpy_params(*args):
        key = tuple(args)
        if key not in made:
            made[key] = jax.tree_util.tree_map(np.asarray, ref_init(jax.random.PRNGKey(3),
                                                                    *args))
        return made[key]

    monkeypatch.setattr(jcli, name, lambda _key, *a: jax.tree_util.tree_map(
        jnp.asarray, numpy_params(*a)))
    monkeypatch.setattr(tcli, name, lambda _gen, *a, device=None: from_jax_params(
        numpy_params(*a), device))


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("kind", ["small", "style3", "style4", "domain", "essence"])
def test_train_classifier_matches_captionax(tmp_path, monkeypatch, kind):
    same_init(monkeypatch, kind)
    jsave, tsave = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    _, jacc = jcli.main(classifier_flags(tmp_path, kind, jsave))
    _, tacc = tcli.main(classifier_flags(tmp_path, kind, tsave) + CPU)
    assert tacc == jacc
    ref, got = load(jsave), load(tsave)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_flat = tree_leaves(got)
    assert len(ref_flat) == len(got_flat)
    steps = EPOCHS * 25  # more than the steps of any kind here
    for (path, a), b in zip(ref_flat, got_flat):
        name = jax.tree_util.keystr(path)
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype and b.shape == a.shape
        key_bias = name.endswith("['attn']['k']['b']")
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=2 * LR * steps if key_bias else 5e-4,
                                   err_msg=name)
    diffs = np.concatenate([np.abs(b - np.asarray(a)).ravel()
                            for (_, a), b in zip(ref_flat, got_flat)])
    assert np.median(diffs) <= 1e-5


def test_warm_start_dims_mismatch(tmp_path):
    donor = str(tmp_path / "donor.pkl")
    tcli.main(classifier_flags(tmp_path, "style3", donor) + CPU)
    base = classifier_flags(tmp_path, "style3", "") + CPU
    with pytest.raises(SystemExit, match="dims mismatch"):
        tcli.main(base + ["--bert-layers", "1", "--warm-start", donor])
    with open(tmp_path / "nobert.pkl", "wb") as f:
        pickle.dump({"embed": np.zeros((2, 2), np.float32)}, f)
    with pytest.raises(SystemExit, match="no 'bert' trunk"):
        tcli.main(base + ["--warm-start", str(tmp_path / "nobert.pkl")])
    _, acc = tcli.main(base + ["--warm-start", donor])
    assert 0.0 <= acc <= 1.0


def test_bert_weights_from_hf_state_dict(tmp_path, monkeypatch):
    """--bert-weights loads a HuggingFace-named state dict into the trunk
    (the weights captionax's conversion gives)."""
    from tests.test_torch_classifiers import hf_state_dict

    seen = {}
    real = tcli.bert_trunk_from_hf_state_dict

    def spy(*a, **kw):
        seen["trunk"] = real(*a, **kw)
        return seen["trunk"]

    monkeypatch.setattr(tcli, "bert_trunk_from_hf_state_dict", spy)
    sd = hf_state_dict(5)
    path = str(tmp_path / "bert.pt")
    torch.save(sd, path)
    vocab_size = sd["embeddings.word_embeddings.weight"].shape[0]
    monkeypatch.setattr(tcli, "resolve_vocab", lambda _cfg: _SizedVocab(vocab_size))
    monkeypatch.setattr(tcli, "resolve_flickr_data", lambda *_a: _TinyData())
    tcli.main(classifier_flags(tmp_path, "style3", "") + CPU
              + ["--bert-weights", path, "--max-epochs", "0"])
    ref = jclf.bert_trunk_from_hf_state_dict(sd, 32, 2)
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(seen["trunk"])):
        assert torch.equal(b, torch.from_numpy(np.array(a)))


class _SizedVocab:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def encode(self, text):
        return [1 + len(w) % (self.n - 1) for w in text.split()]


class _TinyData:
    def __len__(self):
        return 20

    def caption_ids(self, style, index, rng=None):
        return np.arange(1, 6, dtype=np.int32) + index % 3


# ------------------------------------------------- train_hypernet's style losses
@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """Small and BERT classifiers saved by each package."""
    tmp = tmp_path_factory.mktemp("clf")
    out = {}
    for kind in ("small", "style3"):
        out[("captionax", kind)] = str(tmp / f"j_{kind}.pkl")
        out[("port", kind)] = str(tmp / f"t_{kind}.pkl")
        jcli.main(classifier_flags(tmp, kind, out[("captionax", kind)]))
        tcli.main(classifier_flags(tmp, kind, out[("port", kind)]) + CPU)
    return out


HYPER_CASES = {
    "mixup_from_captionax_small": (["--mixup"], ("captionax", "small")),
    "mixup_split_from_port_small": (["--mixup", "--mixup-split"], ("port", "small")),
    "style_aux_from_port_bert": (["--style-aux"], ("port", "style3")),
    "style_aux_split_from_captionax_bert": (["--style-aux", "--style-aux-split"],
                                            ("captionax", "style3")),
}


@pytest.mark.parametrize("case", sorted(HYPER_CASES))
def test_train_hypernet_style_losses(tmp_path, pickles, case):
    extra, which = HYPER_CASES[case]
    d = str(tmp_path / "hn")
    hist = thyper.main(flags(d) + CPU + ["--cache-features", "--max-epochs", "1",
                                         "--log-every", "1", "--style-classifier",
                                         pickles[which]] + extra)
    assert np.isfinite(hist[0]["train_loss_epoch"]) and np.isfinite(hist[0]["val_loss_tf"])
    with open(os.path.join(d, "run.jsonl")) as f:
        logs = [r for r in map(json.loads, f) if "style_loss" in r]
    assert logs and all(np.isfinite([r["train_loss"], r["ce_loss"], r["style_loss"]]).all()
                        for r in logs)


def test_captionax_train_hypernet_reads_the_port_pickle(tmp_path, monkeypatch, pickles):
    """captionax's train_hypernet --mixup on the port's pickle.  Its
    encoder's weights come from the port's init (the same tree; captionax's
    own ResNet-50 init takes ~10 s on the CPU)."""
    from captionax_torch.cli import common as tcommon
    from captionax_torch.interop import to_numpy_tree

    def port_encoder(model_cfg, _key, _weights):
        enc = tcommon.build_encoder(model_cfg, tcommon.model_generators(0)[1], "", "cpu")
        return jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(enc))

    monkeypatch.setattr(jhyper, "build_encoder", port_encoder)
    hist = jhyper.main(flags(str(tmp_path / "j")) + ["--cache-features", "--max-epochs", "1",
                                                     "--mixup", "--style-classifier",
                                                     pickles[("port", "small")]])
    assert np.isfinite(hist[0]["train_loss_epoch"])


def test_both_style_losses_raise(tmp_path, pickles):
    with pytest.raises(ValueError, match="at most one"):
        thyper.main(flags(str(tmp_path / "hn")) + CPU
                    + ["--mixup", "--style-aux", "--style-classifier",
                       pickles[("port", "small")]])


def test_style_loss_steps_draw_per_step(monkeypatch, tmp_path, pickles):
    """The harness gives each step a generator seeded from config.seed and
    the state's step: two runs draw alike, and steps draw apart."""
    seeds = []
    real = tharness.step_generator

    def spy(seed, step):
        seeds.append((seed, step))
        return real(seed, step)

    monkeypatch.setattr(tharness, "step_generator", spy)
    thyper.main(flags(str(tmp_path / "hn")) + CPU + ["--max-epochs", "1", "--seed", "4",
                                                     "--mixup", "--style-classifier",
                                                     pickles[("port", "small")]])
    assert seeds == [(4, s) for s in range(len(seeds))] and len(seeds) >= 2
    a, b = real(4, 0), real(4, 1)
    assert not torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert torch.equal(torch.rand(4, generator=real(4, 0)),
                       torch.rand(4, generator=real(4, 0)))
