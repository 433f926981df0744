"""The port's native caption encoder (captionax_torch/core/textenc_native.py
over csrc/textenc.cc) and the datasets' hook to it, on the CPU.

- The port's native ids equal captionax's ``NativeCaptionEncoder``'s, and
  the port's Python ids (``Vocab.encode``) captionax's, on seeded captions
  (capitals, periods, contractions, quotes, brackets, punctuation; most of
  the words in the vocab, some not), captionax's own edge cases
  (tests/test_cider_native.py) and non-ASCII captions.
- One test pins where the two encoders differ, in both packages: the C++
  lowercases byte by byte and splits on ASCII whitespace only.
- ``FlickrStyleData`` and ``ConceptualCaptionsData`` give the same batches
  with the native encoder on and off on ASCII captions, and a dataset with
  the native encoder on survives a pickle round trip (the encoder is built
  anew where it is unpickled).

Skips where the library cannot be built (no C++ compiler)."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from captionax.core.textenc_native import NativeCaptionEncoder as JNativeCaptionEncoder
from captionax.core.textenc_native import native_available as jnative_available
from captionax.core.vocab import Vocab as JVocab
from captionax_torch.core import textenc_native as tn
from captionax_torch.core.vocab import SPECIAL_TOKENS, STYLE_TOKENS, Vocab
from captionax_torch.data.cc import SEP, ConceptualCaptionsData, load_cc_captions
from captionax_torch.data.flickr import FlickrStyleData
from captionax_torch.data.synthetic import synthetic_image

torch.set_num_threads(1)
T = 25
WORDS = ("a", "dog", "man", "'s", "n't", "is", "are", "running", "on", "the", "grass", "two",
         "children", "play", "in", "park", "she", "said", "hello", "loudly", "twice", "can",
         "wait", "they", "'ll", "run", "&", "jump", "?", "!", ",", ";", "--", "''", "``", "(",
         ")", "café", "école", "naïve", "with", "red", "ball")
EDGE = [
    "",
    "A man's dog isn't here, really!",
    'She said "hello" (loudly) -- twice...',
    "children can't wait; they'll run & jump?",
    "x" * 500,
]
NON_ASCII = ["Café ÉCOLE.", "CAFÉ", "café", "\xa0a dog", "a dog runs", "naïve Dog",
             "the dog runs on the grass", "ÀÉÎ a dog"]


def _vocabs():
    """The same word table in both packages' ``Vocab``."""
    rs = np.random.RandomState(7)
    letters = np.array(list("abcdefghij"))
    words = list(WORDS) + ["".join(rs.choice(letters, rs.randint(2, 6))) for _ in range(60)]
    out = []
    for cls in (Vocab, JVocab):
        v = cls()
        for w in SPECIAL_TOKENS + STYLE_TOKENS + tuple(words):
            v.add_word(w)
        out.append(v)
    return out[0], out[1], words


def _captions(words, n: int, seed: int):
    """Seeded ASCII captions over ``words`` plus words the vocab lacks,
    with capitals, periods and punctuation."""
    rs = np.random.RandomState(seed)
    ascii_words = [w for w in words if w.isascii()] + ["zebra", "Dog", "MAN", "it's", "won't"]
    caps = []
    for _ in range(n):
        toks = list(rs.choice(ascii_words, rs.randint(0, 18)))
        if toks and rs.rand() < 0.5:
            toks[0] = toks[0].capitalize()
        cap = " ".join(toks)
        caps.append(cap + rs.choice(["", ".", " .", "!", "...", ' "ok"']))
    return caps


def _python_ids(vocab, caps, max_len=T):
    out = np.zeros((len(caps), max_len), np.int32)
    for i, c in enumerate(caps):
        ids = vocab.encode(c)[:max_len]
        out[i, :len(ids)] = ids
    return out


@pytest.fixture(scope="module")
def encoders():
    if not (tn.native_available() and jnative_available()):
        pytest.skip("the native caption encoder does not build here (no C++ compiler)")
    tv, jv, words = _vocabs()
    return tv, jv, words, tn.NativeCaptionEncoder(tv), JNativeCaptionEncoder(jv)


@pytest.mark.parametrize("case", ("seeded", "edge", "non_ascii"))
def test_ids_match_captionax(encoders, case):
    tv, jv, words, tenc, jenc = encoders
    caps = {"seeded": _captions(words, 400, 3), "edge": EDGE, "non_ascii": NON_ASCII}[case]
    native = tenc.encode_batch(caps, T)
    assert native.dtype == np.int32 and native.shape == (len(caps), T)
    np.testing.assert_array_equal(native, jenc.encode_batch(caps, T))
    np.testing.assert_array_equal(_python_ids(tv, caps), _python_ids(jv, caps))
    if case != "non_ascii":  # on ASCII the two encoders agree
        np.testing.assert_array_equal(native, _python_ids(tv, caps))
    if case == "seeded":  # the captions hit known words and <unk>
        assert (native > 3).any() and (native == 3).any()


@pytest.mark.parametrize("max_len", (1, 2, 3, 40))
def test_truncation(encoders, max_len):
    tv, _, words, tenc, jenc = encoders
    caps = _captions(words, 50, 11) + EDGE
    np.testing.assert_array_equal(tenc.encode_batch(caps, max_len), _python_ids(tv, caps, max_len))
    np.testing.assert_array_equal(tenc.encode_batch(caps, max_len), jenc.encode_batch(caps, max_len))


def test_native_and_python_differ_off_ascii(encoders):
    """The C++ lowercases byte by byte (csrc/textenc.cc: std::tolower on each
    byte) and splits on ASCII whitespace only; ``Vocab.encode`` takes
    ``str.lower()`` and Unicode whitespace.  Pinned in both packages."""
    tv, jv, _, tenc, jenc = encoders
    café, a, dog = tv("café"), tv("a"), tv("dog")
    want_native = [[1, 3, 2, 0], [1, 3, dog, 2]]  # 'cafÉ' is no word; '\xa0a' neither
    want_python = [[1, café, 2, 0], [1, a, dog, 2]]
    caps = ["CAFÉ", "\xa0a dog"]
    for enc, vocab in ((tenc, tv), (jenc, jv)):
        assert enc.encode_batch(caps, 4).tolist() == want_native
        assert _python_ids(vocab, caps, 4).tolist() == want_python


def _flickr(vocab, caps):
    factual = [(f"im{i // 5}.jpg", c) for i, c in enumerate(caps[:40])]
    return FlickrStyleData(factual=factual, humour=caps[40:48], romantic=caps[48:56],
                           vocab=vocab, image_loader=synthetic_image, max_len=T)


def _cc(vocab, caps, tmp_path):
    path = tmp_path / "cc.txt"
    path.write_text("".join(f"{i}.jpg{SEP}{c}{SEP}{('alamy', 'wordpress')[i % 2]}\n"
                            for i, c in enumerate(caps)))
    return ConceptualCaptionsData(load_cc_captions(str(path)), vocab,
                                  image_loader=synthetic_image, max_len=T)


def _flickr_batches(data):
    return list(data.batches(range(len(data)), 3, seed=4, drop_remainder=False,
                             with_images=False))


def _cc_batches(data):
    return list(data.batches(4, seed=4, drop_remainder=False, with_images=False))


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("kind", ("flickr", "cc"))
def test_dataset_batches_native_on_and_off(encoders, kind, tmp_path, monkeypatch):
    tv, _, words, _, _ = encoders
    caps = [c for c in _captions(words, 120, 5) if c.strip(" .!")][:56]
    make, batches = {"flickr": (_flickr, _flickr_batches),
                     "cc": (lambda v, c: _cc(v, c, tmp_path), _cc_batches)}[kind]
    on = make(tv, caps)
    assert isinstance(on._fast, tn.NativeCaptionEncoder)
    with_native = batches(on)
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_LOAD_FAILED", True)
    off = make(tv, caps)
    assert off._fast is None
    _same_batches(with_native, batches(off))
    assert any((b["captions"] > 3).any() for b in with_native)


def test_dataset_pickles_with_the_native_encoder(encoders):
    tv, _, words, _, _ = encoders
    data = _flickr(tv, _captions(words, 56, 9))
    back = pickle.loads(pickle.dumps(data))
    assert isinstance(back._fast, tn.NativeCaptionEncoder) and back._fast is not data._fast
    _same_batches(_flickr_batches(data), _flickr_batches(back))


def test_vocab_without_special_tokens_takes_the_python_path(encoders):
    """As captionax's hook, a vocab the encoder cannot read falls back."""
    v = Vocab()
    v.add_word("<pad>")
    v.add_word("<unk>")
    data = FlickrStyleData(factual=[("a.jpg", "x")] * 5, humour=["x"], romantic=["x"], vocab=v)
    assert data._fast is None


# ------------------------------------------------- the shared build helper
def test_build_writes_only_into_its_build_dir(tmp_path, monkeypatch):
    """``native_build.build`` compiles into its build directory (never into
    csrc/) under a name that hashes flags and source, leaves no temporary
    file, and does not compile again once the library is there."""
    from captionax_torch.core import native_build

    if not tn.native_available():
        pytest.skip("no C++ compiler here")
    assert native_build.BUILD_DIR == Path(tn.__file__).resolve().parents[1] / "_build"
    assert tn.SOURCE.parent == native_build.CSRC
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    lib = native_build.build(tn.SOURCE)
    assert lib.parent == tmp_path / "build" and lib.name.startswith("libtextenc_")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [lib.name]
    mtime = lib.stat().st_mtime_ns
    monkeypatch.setenv("CXX", "false")  # a second compile would fail
    assert native_build.build(tn.SOURCE) == lib and lib.stat().st_mtime_ns == mtime


def test_failed_build_loads_nothing(tmp_path, monkeypatch):
    from captionax_torch.core import native_build

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert native_build.load(tn.SOURCE, lambda lib: lib) is None
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    assert native_build.load(tn.SOURCE, lambda lib: lib) is None
