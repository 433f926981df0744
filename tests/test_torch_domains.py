"""The port's domain-conditioning schemes (``data/domains.py``) against
captionax's on the same caption files and the same weights (captionax's
inits carried with ``from_jax_params``).

Tolerances:
- word histograms (plain and log) and the host tables of ``one hot`` and
  ``embedding``: exactly equal (the same float64 sums in the same order);
- tf-idf histograms and the pairwise Jensen-Shannon distances: 1e-12
  (the same numpy operations; the bound leaves room for another BLAS);
- the JSD coordinates through classical MDS (scikit-learn blocked for both
  packages, as on a machine without it): 1e-12; through t-SNE (both
  packages call this machine's scikit-learn on the same matrix): 1e-6;
- ``embed`` of every training and zero-shot domain: 1e-6 (f32 products of
  the same weights, summed in another order)."""

import sys

import jax
import numpy as np
import pytest
import torch

from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.data import domains as jdom
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.data import domains as tdom
from captionax_torch.interop import from_jax_params
from captionax_torch.train.state import tree_leaves

torch.set_num_threads(1)
SEP = " " * 5
TRAIN_DOMAINS = ("alamy", "dailymail", "wordpress", "pinimg", "shutterstock", "picdn")
ZERO_SHOT = ("istockphoto", "gettyimages")
EMBED_TOL = 1e-6


def write_captions(path, domains, rows, seed):
    """``rows`` captions of 3-9 words per domain; about a fifth of the
    words are out of the vocab, and one domain's captions are all OOV."""
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(40)] + [f"oov{i}" for i in range(10)]
    with open(path, "w") as f:
        for d, dom in enumerate(domains):
            for i in range(rows):
                pool = words[40:] if d == len(domains) - 1 and seed == 2 else words
                cap = " ".join(rs.choice(pool, rs.randint(3, 10)))
                f.write(f"{dom}_{i}.jpg{SEP}{cap}{SEP}{dom}\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("domains")
    train = write_captions(tmp / "cc.txt", TRAIN_DOMAINS, 7, 1)
    oneshot = write_captions(tmp / "oneshot.txt", ZERO_SHOT, 4, 2)
    lines = [" ".join(f"w{i}" for i in range(j, j + 8)) for j in range(0, 32, 2)]
    jv, tv = jbuild_vocab(lines), tbuild_vocab(lines)
    assert jv.w2i == tv.w2i
    return train, oneshot, jv, tv


def both(corpus, scheme, zero_shot=ZERO_SHOT, **kw):
    train, oneshot, jv, tv = corpus
    args = dict(hyper_emb=6, cap_path=train, zero_shot_domains=list(zero_shot),
                zero_shot_path=oneshot, **kw)
    return (jdom.DomainEmbedder(scheme, jv, list(TRAIN_DOMAINS), **args),
            tdom.DomainEmbedder(scheme, tv, list(TRAIN_DOMAINS), **args))


@pytest.fixture
def no_sklearn(monkeypatch):
    """Block scikit-learn for both packages, as on a machine without it."""
    for name in ("sklearn", "sklearn.manifold"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("log_scale", [False, True])
def test_word_histograms_equal(corpus, log_scale):
    train, _, jv, tv = corpus
    ref = jdom.word_histograms(train, jv, TRAIN_DOMAINS, log_scale)
    got = tdom.word_histograms(train, tv, TRAIN_DOMAINS, log_scale)
    assert list(got) == list(ref)
    for d in ref:
        np.testing.assert_array_equal(got[d], ref[d])


def test_tfidf_histograms(corpus):
    train, _, jv, tv = corpus
    ref = jdom.tfidf_histograms(train, jv, TRAIN_DOMAINS)
    got = tdom.tfidf_histograms(train, tv, TRAIN_DOMAINS)
    assert list(got) == list(ref)
    for d in ref:
        np.testing.assert_allclose(got[d], ref[d], rtol=0, atol=1e-12)


def test_jensen_shannon_matrix(corpus):
    train, oneshot, jv, _ = corpus
    hists = jdom.word_histograms(train, jv, TRAIN_DOMAINS)
    hists.update(jdom.word_histograms(oneshot, jv, ZERO_SHOT))
    names = list(hists)
    for a in names:
        for b in names:
            ref = jdom.jensen_shannon(hists[a], hists[b])
            assert abs(tdom.jensen_shannon(hists[a], hists[b]) - ref) <= 1e-12
    assert tdom.jensen_shannon(np.zeros(4), np.ones(4)) == 0.0


def _coords(corpus, zero_shot):
    train, oneshot, jv, tv = corpus
    ref = jdom.jsd_tsne_coords(train, jv, TRAIN_DOMAINS, 2, oneshot, zero_shot)
    got = tdom.jsd_tsne_coords(train, tv, TRAIN_DOMAINS, 2, oneshot, zero_shot)
    assert list(got) == list(ref)
    return ref, got


@pytest.mark.parametrize("zero_shot", [(), ZERO_SHOT], ids=["train", "with_zero_shot"])
def test_jsd_coords_mds(corpus, no_sklearn, zero_shot):
    ref, got = _coords(corpus, zero_shot)
    for d in ref:
        assert got[d].dtype == np.float32 and got[d].shape == (2,)
        np.testing.assert_allclose(got[d], ref[d], rtol=0, atol=1e-12)


def test_jsd_coords_tsne(corpus):
    pytest.importorskip("sklearn.manifold")
    ref, got = _coords(corpus, ZERO_SHOT)
    for d in ref:
        np.testing.assert_allclose(got[d], ref[d], rtol=0, atol=1e-6)


def test_jsd_zero_shot_moves_training_coords(corpus, no_sklearn):
    """The whole distance matrix is embedded again (captionax's semantics):
    adding zero-shot domains moves the training domains' coordinates."""
    alone, _ = _coords(corpus, ())
    grown, _ = _coords(corpus, ZERO_SHOT)
    assert any(np.abs(grown[d] - alone[d]).max() > 1e-3 for d in TRAIN_DOMAINS)


def carried(jemb, temb, seed=3):
    jp = jax.tree_util.tree_map(np.asarray, jemb.init_params(jax.random.PRNGKey(seed)))
    return jp, from_jax_params(jp, "cpu")


def table_equal(jemb, temb):
    assert list(temb.table) == list(jemb.table)
    for d, v in jemb.table.items():
        w = temb.table[d]
        if isinstance(v, np.ndarray):
            assert w.dtype == v.dtype
            np.testing.assert_array_equal(w, v)
        else:
            assert w == v


@pytest.mark.parametrize("scheme", tdom.SCHEMES)
def test_embedder_tables_and_embed(corpus, no_sklearn, scheme):
    jemb, temb = both(corpus, scheme)
    assert temb.hyper_emb == jemb.hyper_emb
    table_equal(jemb, temb)
    jp, tp = carried(jemb, temb)
    own = temb.init_params(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(x.shape) for x in tree_leaves(own)] == [
        x.shape for x in jax.tree_util.tree_leaves(jp)]
    for dom in TRAIN_DOMAINS + ZERO_SHOT:
        value = np.asarray(jemb.host_vector(dom))
        ref = np.asarray(jemb.embed(jp, value))
        got = temb.embed(tp, value)
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (temb.hyper_emb,)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=EMBED_TOL, err_msg=dom)


def test_one_hot_past_its_width_is_a_zero_row(corpus):
    jemb, temb = both(corpus, "one hot", zero_shot=())
    width = temb.hyper_emb
    assert width == len(TRAIN_DOMAINS)
    for value in (0, width - 1, width, 103, -1):
        got = temb.embed({}, np.asarray(value))
        ref = np.asarray(jemb.embed({}, np.asarray(value)))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.sum() == (1.0 if 0 <= value < width else 0.0)


@pytest.mark.parametrize("scheme", ["one hot", "embedding"])
def test_register_zero_shot(corpus, scheme):
    """Built with the styles f/h/r as zero-shot ids (as train_hyper_combine
    builds it), restored, then the unseen domains registered: the same ids
    in both packages, the table grown by the new rows only (the trained
    rows intact), a second registration a no-op."""
    jemb, temb = both(corpus, scheme, zero_shot=list("fhr"))
    jp, tp = carried(jemb, temb)
    width = temb.hyper_emb
    jp2 = jemb.register_zero_shot(jp, list(ZERO_SHOT), jax.random.PRNGKey(7))
    tp2 = temb.register_zero_shot(tp, list(ZERO_SHOT), torch.Generator().manual_seed(7))
    table_equal(jemb, temb)
    assert temb.zero_shot_domains == jemb.zero_shot_domains == list("fhr") + list(ZERO_SHOT)
    if scheme == "one hot":
        assert temb.table["istockphoto"] == 103 and tp2 == {}
        vec = temb.embed(tp2, np.asarray(temb.host_vector("istockphoto")))
        assert tuple(vec.shape) == (width,) and not vec.any()
    else:
        n = len(TRAIN_DOMAINS) + 3
        assert tuple(tp2["table"].shape) == np.asarray(jp2["table"]).shape == (n + 2, 6)
        assert torch.equal(tp2["table"][:n], tp["table"])
        assert temb.table["istockphoto"] == n and temb.num_entries == n + 2
    again = temb.register_zero_shot(tp2, list(ZERO_SHOT), torch.Generator())
    assert again is tp2


@pytest.mark.parametrize("scheme", ["histograme", "histograme log", "histograme tfidf", "JSD"])
def test_register_zero_shot_raises_for_the_mlp_schemes(corpus, no_sklearn, scheme):
    jemb, temb = both(corpus, scheme, zero_shot=())
    with pytest.raises(ValueError, match="embeds arbitrary domains"):
        jemb.register_zero_shot({}, ["new"], jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="embeds arbitrary domains"):
        temb.register_zero_shot({}, ["new"], torch.Generator())
