"""The port's native CIDEr scorer (captionax_torch/eval/cider_native.py over
csrc/cider.cc), the metrics that now take CIDEr from it, and the PTB
tokenizer (captionax_torch/eval/ptbtok.py), against captionax on the CPU.

- ``cider_score_native`` equals captionax's within 1e-12 and captionax's
  Python ``cider_score`` within 1e-9 (tests/test_cider_native.py's bounds),
  on captionax's cases (an empty hypothesis among them), unicode and a
  seeded corpus of 300 images.  Where a no-break space parts two words the
  C++ scorer (split on ' ' only) differs from the Python one (any
  whitespace): the port equals captionax's native scorer there, and the
  test pins that the two scorers differ.  Without the library, the port
  falls back to its Python scorer.
- ``metric_score_test`` and ``metric_score`` (through ``_assemble``) equal
  captionax's within 1e-9, with the native scorer and without it.
- ``ptb_tokenize`` and ``PTBTokenizer.tokenize`` equal captionax's on
  brackets, quotes and every ``PUNCTUATIONS`` entry, and the Java backend
  runs in both packages against one stub ``java`` on ``PATH``.

The native cases skip where the library cannot be built (no C++ compiler)."""

import os

import numpy as np
import pytest
import torch

from captionax.core.vocab import Vocab as JVocab
from captionax.eval import PTBTokenizer as JPTBTokenizer
from captionax.eval import ptb_tokenize as jptb_tokenize
from captionax.eval import ptbtok as jptbtok
from captionax.eval.cider import cider_score as jcider_score
from captionax.eval.cider_native import cider_score_native as jcider_native
from captionax.eval.cider_native import native_available as jnative_available
from captionax.eval.metrics import metric_score as jmetric_score
from captionax.eval.metrics import metric_score_test as jmetric_score_test
from captionax_torch.core.vocab import SPECIAL_TOKENS, STYLE_TOKENS, Vocab
from captionax_torch.eval import PTBTokenizer, ptb_tokenize, ptbtok
from captionax_torch.eval import cider_native as cn
from captionax_torch.eval.cider import cider_score
from captionax_torch.eval.metrics import metric_score, metric_score_test

torch.set_num_threads(1)
METRIC_TOL = 1e-9
HYPS = [
    "a child in a pink dress is climbing stairs",
    "a dog runs in the grass",
    "two men are playing chess in a park",
    "",  # empty hypothesis
]
REFS = [
    ["a child in a pink dress is climbing up a set of stairs",
     "a little girl climbing the stairs"],
    ["a dog runs after a ball in the green grass"],
    ["two men play chess outdoors in the park"],
    ["anything at all"],
]
UNICODE = (["un chien très vite", "a b"], [["un chien très rapide"], ["a b"]])
# a no-break space between 'runs' and 'in': one word for the C++ scorer
NBSP = (["a dog runs\xa0in the grass", "two men play chess", "a cat sleeps"],
        [["a dog runs in the grass", "dog in grass"], ["two men play chess in a park"],
         ["a cat sleeps on a mat"]])


def _corpus(n: int, seed: int):
    rs = np.random.RandomState(seed)
    words = np.array("a the dog cat man woman runs sits on in park grass ball red two "
                     "children play with near water".split())

    def sentence():
        return " ".join(rs.choice(words, rs.randint(3, 12)))

    return ([sentence() for _ in range(n)],
            [[sentence() for _ in range(rs.randint(1, 6))] for _ in range(n)])


CASES = {"coco": (HYPS, REFS), "unicode": UNICODE, "seeded": _corpus(300, 1)}


@pytest.fixture(scope="module")
def native():
    if not (cn.native_available() and jnative_available()):
        pytest.skip("the native CIDEr scorer does not build here (no C++ compiler)")


@pytest.fixture
def python_only(monkeypatch):
    monkeypatch.setattr(cn, "_LIB", None)
    monkeypatch.setattr(cn, "_LOAD_FAILED", True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cider_native_matches_captionax(native, case):
    hyps, refs = CASES[case]
    mean, scores = cn.cider_score_native(hyps, refs)
    j_mean, j_scores = jcider_native(hyps, refs)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-12)
    assert abs(mean - j_mean) <= 1e-12
    py_mean, py_scores = jcider_score(hyps, refs)
    np.testing.assert_allclose(scores, py_scores, rtol=0, atol=1e-9)
    assert abs(mean - py_mean) <= 1e-9
    assert scores.shape == (len(hyps),) and scores.max() > 0
    if case == "coco":
        assert scores[3] == 0.0  # the empty hypothesis


def test_cider_native_splits_on_spaces_only(native):
    hyps, refs = NBSP
    mean, scores = cn.cider_score_native(hyps, refs)
    j_mean, j_scores = jcider_native(hyps, refs)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-12)
    py_scores = cider_score(hyps, refs)[1]
    np.testing.assert_allclose(py_scores, jcider_score(hyps, refs)[1], rtol=0, atol=1e-12)
    assert scores[0] < py_scores[0] - 0.5  # 'runs\xa0in' is one word natively
    np.testing.assert_allclose(scores[1:], py_scores[1:], rtol=0, atol=1e-9)


def test_cider_native_empty_and_fallback(native, python_only):
    mean, scores = cn.cider_score_native([], [])
    assert mean == 0.0 and scores.shape == (0,)
    hyps, refs = CASES["seeded"]
    mean, scores = cn.cider_score_native(hyps, refs)
    want_mean, want = cider_score(hyps, refs)
    np.testing.assert_array_equal(scores, want)
    assert mean == want_mean


def test_cider_native_refuses_mismatched_lengths(native):
    with pytest.raises(ValueError, match="reference sets"):
        cn.cider_score_native(HYPS, REFS[:2])


# ----------------------------------------------------------------- metrics
def _vocabs():
    words = "a the dog cat man woman runs sits on in park grass ball red two".split()
    out = []
    for cls in (Vocab, JVocab):
        v = cls()
        for w in SPECIAL_TOKENS + STYLE_TOKENS + tuple(words):
            v.add_word(w)
        out.append(v)
    return out


def _ids(rs, V, rows, T):
    """Rows of <s>, random word ids, </s>, padding."""
    out = np.zeros((rows, T), np.int32)
    for i in range(rows):
        n = rs.randint(2, T - 1)
        out[i, 0] = 1
        out[i, 1:n] = rs.randint(7, V, n - 1)
        out[i, n] = 2
    return out


@pytest.mark.parametrize("route", ("native", "python"))
@pytest.mark.parametrize("which", ("metric_score_test", "metric_score"))
def test_metrics_match_captionax(route, which, monkeypatch):
    if route == "native" and not cn.native_available():
        pytest.skip("the native CIDEr scorer does not build here (no C++ compiler)")
    if route == "python":
        monkeypatch.setattr(cn, "_LIB", None)
        monkeypatch.setattr(cn, "_LOAD_FAILED", True)
    tv, jv = _vocabs()
    rs = np.random.RandomState(4)
    gt = _ids(rs, len(tv), 12, 14)
    if which == "metric_score_test":
        pred = _ids(rs, len(tv), 1, 14)[0]
        got, want = metric_score_test(gt, pred, tv), jmetric_score_test(gt, pred, jv)
    else:
        logits = rs.randn(12, 14, len(tv)).astype(np.float32)
        got, want = metric_score(gt, logits, tv), jmetric_score(gt, logits, jv)
    assert set(got) == set(want) == {"bleu1", "bleu2", "bleu3", "bleu4", "meteor", "rougeL",
                                     "cider"}
    for k in want:
        assert abs(got[k] - float(want[k])) <= METRIC_TOL, (k, got[k], want[k])
    assert got["cider"] > 0


# ------------------------------------------------------------ PTB tokenizer
CAPTIONS = [
    "A man (in a red hat) rides a {bicycle}.",
    'She said "hello" -- and left...',
    "It's the dog's ball; isn't it?",
    "``Quoted'' text, with `single' quotes!",
    "Two -LRB- tags -RRB- and -LCB- more -RCB-: done",
    "",
    "   ",
    "UPPER case & symbols % $ 5.5 #1",
] + [f"word {p} word{p}next {p}" for p in jptbtok.PUNCTUATIONS]


def test_punctuations_match():
    assert ptbtok.PUNCTUATIONS == jptbtok.PUNCTUATIONS


@pytest.mark.parametrize("i", range(len(CAPTIONS)))
def test_ptb_tokenize_matches_captionax(i):
    assert ptb_tokenize(CAPTIONS[i]) == jptb_tokenize(CAPTIONS[i])


def _batch():
    return {7: [{"caption": c} for c in CAPTIONS[:5]], "im2": [{"caption": c} for c in CAPTIONS[5:]],
            3: [{"caption": "a line\nwith a newline."}]}


def test_ptb_tokenizer_matches_captionax():
    got, want = PTBTokenizer().tokenize(_batch()), JPTBTokenizer().tokenize(_batch())
    assert got == want and list(got) == [7, "im2", 3]


def test_ptb_tokenizer_java_backend_matches_captionax(tmp_path, monkeypatch):
    """The CoreNLP branch, each package against one stub ``java`` that
    records its arguments and lowercases and splits punctuation off."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "java_args.txt"
    stub = bin_dir / "java"
    stub.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> '{log}'\n"
                    "tr 'A-Z' 'a-z' | sed 's/\\([.,!?;]\\)/ \\1 /g'\n")
    stub.chmod(0o755)
    jar = tmp_path / "stanford-corenlp.jar"
    jar.write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    got = PTBTokenizer(str(jar)).tokenize(_batch())
    want = JPTBTokenizer(str(jar)).tokenize(_batch())
    assert got == want
    assert got[3] == ["a line with a newline"] and got[7][0] == "a man (in a red hat) rides a {bicycle}"
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and calls[0] == calls[1] == (
        f"-cp {jar} edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase")
    # a jar path that does not exist takes the Python tokenizer
    assert PTBTokenizer(str(tmp_path / "none.jar")).tokenize(_batch()) == (
        JPTBTokenizer().tokenize(_batch()))
