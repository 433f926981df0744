"""The port's Conceptual Captions data module (captionax_torch/data/cc.py)
against captionax's, on caption files written in the test: the same rows,
domains, chunks, batches and splits for the same seeds, exactly."""

import random

import numpy as np
import pytest

from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.data import cc as jcc
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.data import cc as tcc

SEP = " " * 5
DOMAINS = ("alamy", "dailymail", "wordpress", "picture")


def write_cc(path, per_domain=(9, 5, 3, 1), extra_lines=True):
    """Rows of four domains of different sizes, interleaved, plus lines the
    loader must skip (too few fields) and a domain with a trailing space."""
    rs = np.random.RandomState(0)
    words = ["a", "dog", "runs", "on", "the", "grass", "with", "ball", "red", "house",
             "zebra"]
    lines = []
    for i in range(max(per_domain)):
        for d, dom in enumerate(DOMAINS):
            if i < per_domain[d]:
                cap = " ".join(rs.choice(words, rs.randint(3, 12)))
                lines.append(f"{d}_{i}.jpg{SEP}{cap}{SEP}{dom}" + (" " if d == 3 else ""))
    if extra_lines:
        lines += ["broken line without fields", f"x.jpg{SEP}only a caption"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture()
def cc_path(tmp_path):
    return write_cc(tmp_path / "cc.txt")


def vocabs(rows):
    caps = [c for _, c, _ in rows]
    return jbuild_vocab(caps, []), tbuild_vocab(caps, [])


def test_load_and_domains(tmp_path, cc_path):
    assert tcc.SEP == jcc.SEP
    assert tcc.load_cc_captions(cc_path) == jcc.load_cc_captions(cc_path)
    other = write_cc(tmp_path / "other.txt", per_domain=(2, 0, 0, 4), extra_lines=False)
    for paths in ((cc_path,), (other, cc_path), (cc_path, "", other)):
        assert tcc.domain_list(*paths) == jcc.domain_list(*paths)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("allowed", [None, set(range(0, 18, 2))])
def test_domain_chunks(cc_path, drop_remainder, allowed):
    rows = jcc.load_cc_captions(cc_path)
    by_domain = {}
    for i, (_, _, d) in enumerate(rows):
        by_domain.setdefault(d, []).append(i)
    for seed in range(3):
        got = tcc.domain_chunks({k: list(v) for k, v in by_domain.items()}, 4,
                                random.Random(seed), drop_remainder, allowed)
        ref = jcc.domain_chunks({k: list(v) for k, v in by_domain.items()}, 4,
                                random.Random(seed), drop_remainder, allowed)
        assert got == ref


@pytest.mark.parametrize("url", [
    "http://www.alamy.com/img1.jpg", "https://i.dailymail.co.uk/a/b.jpg",
    "http://cdn.example.org:8080/x", "ftp://localhost/file", "http://news.bbc.co.uk",
    "www.picture.net/p", "justahost"])
def test_extract_domain(url):
    assert tcc.extract_domain(url) == jcc.extract_domain(url)


def _loader(name):
    """Deterministic images of mixed sizes, every third one gray."""
    i = int(name.split("_")[1].split(".")[0])
    rs = np.random.RandomState(i)
    hw = (40 + 8 * i, 56)
    if i % 3 == 0:
        return rs.randint(0, 256, hw, dtype=np.uint8)
    return rs.randint(0, 256, hw + (3,), dtype=np.uint8)


@pytest.mark.parametrize("with_images", [False, True])
def test_batches_and_split(cc_path, with_images):
    rows = jcc.load_cc_captions(cc_path)
    jv, tv = vocabs(rows)
    kw = dict(image_loader=_loader if with_images else None, max_len=8, image_hw=(32, 32))
    jd, td = jcc.ConceptualCaptionsData(rows, jv, **kw), tcc.ConceptualCaptionsData(
        rows, tv, **kw)
    assert len(td) == len(jd) and td.domains == jd.domains and td.by_domain == jd.by_domain
    assert td.split_by_domain(2, 1, seed=3) == jd.split_by_domain(2, 1, seed=3)
    train, _, _ = jd.split_by_domain(seed=1)
    for args in (dict(seed=0), dict(seed=5, indices=train),
                 dict(seed=2, drop_remainder=False)):
        got = list(td.batches(4, with_images=with_images, **args))
        ref = list(jd.batches(4, with_images=with_images, **args))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for k in r:
                if isinstance(r[k], np.ndarray):
                    assert g[k].dtype == r[k].dtype
                    np.testing.assert_array_equal(g[k], r[k])
                else:
                    assert g[k] == r[k]
