"""The port's Conceptual Captions data against captionax's on the same
files: ``cc_stream`` (``load_gcc_tsv``; ``StreamingCC`` with no fetcher,
an injected fetcher whose images need a resize, and a fetcher that
raises, which must give the placeholder image and ``FALLBACK_CAPTION``)
and ``combine`` (``style_histograms``; ``CombinedData``'s batch sequence
over two epochs with ``drop_remainder`` on and off).  Everything here is
host-side numpy, so every comparison is exact: images byte for byte,
captions, domains and dataset indices equal."""

import numpy as np
import pytest

from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.data import cc as jcc
from captionax.data import cc_stream as jstream
from captionax.data import combine as jcombine
from captionax.data import synthetic as jsynth
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.data import cc as tcc
from captionax_torch.data import cc_stream as tstream
from captionax_torch.data import combine as tcombine
from captionax_torch.data import synthetic as tsynth
from tests.fixtures.gru_fixture import CAPTIONS

SEP = " " * 5
HOSTS = ("http://www.alamy.com/a{}.jpg", "https://i.dailymail.co.uk/i/{}.jpg",
         "http://cdn.shutterstock.com:8080/x/{}.png", "http://example.org/{}.jpg",
         "http://images.wordpress.com/{}.jpg")


def gcc_rows(n=30):
    rows = [f"a caption with words number {i}\t{HOSTS[i % len(HOSTS)].format(i)}"
            for i in range(n)]
    rows.insert(7, "a line without a url")
    return "\n".join(rows) + "\n"


@pytest.fixture(scope="module")
def vocabs():
    lines = [" ".join(f"w{i}" for i in range(j, j + 6)) for j in range(0, 30, 2)]
    lines += ["a caption with words number portrait of smiling woman"] * 2
    jv, tv = jbuild_vocab(lines), tbuild_vocab(lines)
    assert jv.w2i == tv.w2i
    return jv, tv


@pytest.fixture(scope="module")
def gcc_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("gcc") / "gcc.tsv"
    path.write_text(gcc_rows())
    return str(path)


@pytest.mark.parametrize("limit", [0, 5])
def test_load_gcc_tsv(gcc_file, limit):
    ref = jstream.load_gcc_tsv(gcc_file, limit=limit)
    got = tstream.load_gcc_tsv(gcc_file, limit=limit)
    assert got == ref and len(got) == (limit or 24)
    assert {d for _, _, d in got} <= set(tstream.DEFAULT_SITES)
    assert tstream.DEFAULT_SITES == jstream.DEFAULT_SITES
    assert tstream.FALLBACK_CAPTION == jstream.FALLBACK_CAPTION
    sites = ("alamy",)
    assert tstream.load_gcc_tsv(gcc_file, sites) == jstream.load_gcc_tsv(gcc_file, sites)


def fetched(url):
    """An injected fetcher: a seeded image of a size that needs a resize."""
    rs = np.random.RandomState(len(url))
    return rs.randint(0, 256, (40 + len(url) % 7, 50, 3), np.uint8)


def failing(url):
    raise OSError(f"no network for {url}")


def flaky(url):
    if "dailymail" in url:
        raise OSError("unreachable")
    return fetched(url)


@pytest.mark.parametrize("fetcher", [None, fetched, failing, flaky],
                         ids=["none", "fetched", "failing", "flaky"])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_streaming_cc_batches(gcc_file, vocabs, fetcher, drop_remainder):
    jv, tv = vocabs
    rows = tstream.load_gcc_tsv(gcc_file)
    ref = list(jstream.StreamingCC(rows, jv, fetcher, max_len=8, image_hw=(32, 32)).batches(
        4, seed=3, drop_remainder=drop_remainder))
    got = list(tstream.StreamingCC(rows, tv, fetcher, max_len=8, image_hw=(32, 32)).batches(
        4, seed=3, drop_remainder=drop_remainder))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b) and a["domain"] == b["domain"]
        for k in ("images", "captions", "lengths"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    fallback = np.asarray(tv.encode(tstream.FALLBACK_CAPTION)[:8])
    for b in got:
        failed = fetcher is failing or (fetcher is flaky and b["domain"] == "dailymail")
        for img, cap in zip(b["images"], b["captions"]):
            assert img.shape == (32, 32, 3)
            assert np.array_equal(cap[:len(fallback)], fallback) == failed
            if failed or fetcher is None:
                # the placeholder: 8x8 blocks of one colour each
                assert (img[::4, ::4] == img[1::4, 1::4]).all()


@pytest.fixture(scope="module")
def combined(vocabs):
    """Both packages' CombinedData over 9 synthetic Flickr images and a CC
    file of 4 domains (3-9 rows each)."""
    jv, tv = vocabs
    with open(CAPTIONS) as f:
        lines = [line.split("\t", 1)[1].strip() for line in f]
    rs = np.random.RandomState(0)
    rows = []
    for d, dom in enumerate(("alamy", "dailymail", "wordpress", "pinimg")):
        for i in range(3 + 2 * d):
            rows.append((f"{dom}{i}.jpg", " ".join(rs.choice([f"w{k}" for k in range(30)], 5)),
                         dom))
    out = {}
    for name, vocab, synth, cc in (("captionax", jv, jsynth, jcc), ("port", tv, tsynth, tcc)):
        flickr = synth.synthetic_flickr_style(9, vocab, 8, lines)
        data = cc.ConceptualCaptionsData(rows, vocab, image_loader=None, max_len=8)
        out[name] = (flickr, data, (jcombine if name == "captionax" else tcombine).CombinedData(
            flickr, data))
    return out


def sequence(mixer, seed, drop_remainder, fl_idx, cc_idx):
    out = []
    for b in mixer.batches(3, seed=seed, flickr_indices=fl_idx, cc_indices=cc_idx,
                           drop_remainder=drop_remainder):
        out.append((b["domain"], b["captions"], b["indices"], b.get("images")))
    return out


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("split", [False, True], ids=["all", "split"])
def test_combined_batch_sequence(combined, drop_remainder, split):
    """Two epochs (seeds 5 and 6, as the CLIs pass seed + epoch): the
    domains, captions, dataset indices and images of every batch equal."""
    fl, cc, _ = combined["port"]
    fl_idx = fl.splits(seed=0)[0] if split else None
    cc_idx = cc.split_by_domain(1, 1, seed=0)[0] if split else None
    for seed in (5, 6):
        ref = sequence(combined["captionax"][2], seed, drop_remainder, fl_idx, cc_idx)
        got = sequence(combined["port"][2], seed, drop_remainder, fl_idx, cc_idx)
        assert len(got) == len(ref) > 0
        for (d, c, i, im), (rd, rc, ri, rim) in zip(got, ref):
            assert d == rd
            np.testing.assert_array_equal(c, rc)
            np.testing.assert_array_equal(i, ri)
            assert (im is None) == (rim is None)
            if im is not None:
                np.testing.assert_array_equal(im, rim)
        domains = {d for d, *_ in got}
        assert domains & {"f", "h", "r"} and domains - {"f", "h", "r"}


def test_combined_domains(combined):
    assert combined["port"][2].domains == combined["captionax"][2].domains
    assert tcombine.FLICKR_PSEUDO_DOMAINS == jcombine.FLICKR_PSEUDO_DOMAINS


def test_style_histograms(combined, vocabs):
    jv, tv = vocabs
    ref = jcombine.style_histograms(combined["captionax"][0], jv)
    got = tcombine.style_histograms(combined["port"][0], tv)
    assert list(got) == list(ref) == ["f", "h", "r"]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].shape == (len(tv) + 1,) and got[k].sum() > 0
