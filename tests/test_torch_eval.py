"""The port's caption metrics on the CPU against captionax's, on seeded
random id batches over the fixture vocab: BLEU-1..4 (every field of the
dict), ROUGE-L, METEOR (with and without the lite synonym table), CIDEr,
``metric_score``, ``metric_score_test`` and ``CaptionMetrics``.
captionax's ``_assemble`` takes CIDEr from its native scorer, so these
cases also hold the port's Python CIDEr to the native one.  Tolerance:
1e-9 (both sides sum the same float64 terms)."""

import numpy as np
import pytest
import torch

from captionax.core.vocab import build_vocab as jbuild_vocab
from captionax.core.vocab import extract_factual_caption_lines as jextract
from captionax.eval import bleu as jbleu
from captionax.eval import cider as jcider
from captionax.eval import meteor as jmeteor
from captionax.eval import metrics as jmetrics
from captionax.eval import rouge as jrouge
from captionax.eval import wordnet_lite as jlite
from captionax.eval.cider_native import cider_score_native
from captionax_torch.core.vocab import build_vocab as tbuild_vocab
from captionax_torch.core.vocab import extract_factual_caption_lines as textract
from captionax_torch.eval import bleu as tbleu
from captionax_torch.eval import cider as tcider
from captionax_torch.eval import meteor as tmeteor
from captionax_torch.eval import metrics as tmetrics
from captionax_torch.eval import rouge as trouge
from captionax_torch.eval import wordnet_lite as tlite
from tests.fixtures.gru_fixture import CAPTIONS

torch.set_num_threads(1)
TOL = 1e-9
SEEDS = (0, 1, 2, 3)
B, T = 12, 10


@pytest.fixture(scope="module")
def vocabs():
    jv = jbuild_vocab(jextract(CAPTIONS))
    tv = tbuild_vocab(textract(CAPTIONS))
    assert jv.w2i == tv.w2i and jv.i2w == tv.i2w
    return jv, tv


def id_batch(seed, n_vocab):
    """gt [B, T] and hypotheses [B, T]: ``<s>`` words ``</s>`` padding; each
    hypothesis keeps some of its caption's words and replaces the rest, so
    every n-gram order has matches."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, T), np.int32)
    hyp = np.zeros((B, T), np.int32)
    for i in range(B):
        n = rs.randint(2, T - 1)
        words = rs.randint(4, n_vocab, n)
        gt[i, 0], gt[i, 1:n + 1] = 1, words
        if n + 1 < T:
            gt[i, n + 1] = 2
        keep = rs.rand(n) < 0.6
        h = np.where(keep, words, rs.randint(4, n_vocab, n))
        m = rs.randint(1, n + 1)
        hyp[i, 0], hyp[i, 1:m + 1] = 1, h[:m]
        if m + 1 < T:
            hyp[i, m + 1] = 2
    return gt, hyp


def texts(vocab, gt, hyp):
    hyps = [vocab.decode(h) for h in hyp]
    refs = [vocab.decode(g) for g in gt]
    return hyps, refs


def assert_dicts(got, ref, tol=TOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(ref[k], np.float64), rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("order", (1, 2, 3, 4))
def test_corpus_bleu(vocabs, seed, order):
    jv, tv = vocabs
    gt, hyp = id_batch(seed, len(jv))
    hyps, refs = texts(tv, gt, hyp)
    refs = [[r] for r in refs]
    assert_dicts(tbleu.corpus_bleu(hyps, refs, max_order=order),
                 jbleu.corpus_bleu(hyps, refs, max_order=order))


@pytest.mark.parametrize("seed", SEEDS)
def test_rouge_meteor_cider(vocabs, seed):
    jv, tv = vocabs
    gt, hyp = id_batch(seed, len(jv))
    hyps, refs = texts(tv, gt, hyp)
    hs, rs = [" ".join(h) for h in hyps], [" ".join(r) for r in refs]
    assert abs(trouge.rouge_l_corpus(hs, rs) - jrouge.rouge_l_corpus(hs, rs)) <= TOL
    assert abs(tmeteor.meteor_corpus(hs, rs) - jmeteor.meteor_corpus(hs, rs)) <= TOL
    for h, r in zip(hs, rs):
        assert abs(tmeteor.meteor_score(h, r, synonyms=tlite.lite_syns)
                   - jmeteor.meteor_score(h, r, synonyms=jlite.lite_syns)) <= TOL
    got, per = tcider.cider_score(hs, [[r] for r in rs])
    ref, ref_per = jcider.cider_score(hs, [[r] for r in rs])
    native, _ = cider_score_native(hs, [[r] for r in rs])
    assert abs(got - ref) <= TOL and abs(got - native) <= TOL
    np.testing.assert_allclose(per, ref_per, rtol=0, atol=TOL)


def test_lite_synonym_table():
    assert tlite.LITE_SYNONYMS == jlite.LITE_SYNONYMS


@pytest.mark.parametrize("seed", SEEDS)
def test_metric_score_and_test(vocabs, seed):
    jv, tv = vocabs
    gt, hyp = id_batch(seed, len(jv))
    logits = np.random.RandomState(seed + 50).randn(B, T, len(jv)).astype(np.float32)
    logits[np.arange(B)[:, None], np.arange(T)[None], hyp] += 10.0  # argmax = hyp
    assert_dicts(tmetrics.metric_score(gt, logits, tv), jmetrics.metric_score(gt, logits, jv))
    assert_dicts(tmetrics.metric_score(torch.from_numpy(gt), torch.from_numpy(logits), tv),
                 jmetrics.metric_score(gt, logits, jv))
    for i in (0, 5):
        assert_dicts(tmetrics.metric_score_test(gt, hyp[i], tv),
                     jmetrics.metric_score_test(gt, hyp[i], jv))
    assert tmetrics.logits_to_text(logits[0], tv) == jmetrics.logits_to_text(logits[0], jv)
    assert (tmetrics.logits_to_text(torch.from_numpy(logits[1]), tv, tokenized=True)
            == jmetrics.logits_to_text(logits[1], jv, tokenized=True))
    for row in hyp:
        assert tmetrics.clean_sentence(row, tv) == jmetrics.clean_sentence(row, jv)
        assert tmetrics.ids_to_text(row, tv) == jmetrics.ids_to_text(row, jv)


@pytest.mark.parametrize("seed", SEEDS)
def test_caption_metrics_compute(vocabs, seed):
    """Two batches accumulated (one as ids, one as logits): the corpus
    metrics, CIDEr's batch document frequencies included."""
    jv, tv = vocabs
    got, ref = tmetrics.CaptionMetrics(tv), jmetrics.CaptionMetrics(jv)
    assert_dicts(got.compute(), ref.compute())  # empty
    gt, hyp = id_batch(seed, len(jv))
    got.add_batch_ids(torch.from_numpy(gt), torch.from_numpy(hyp))
    ref.add_batch_ids(gt, hyp)
    gt2, hyp2 = id_batch(seed + 100, len(jv))
    logits = np.random.RandomState(seed).randn(B, T, len(jv)).astype(np.float32)
    logits[np.arange(B)[:, None], np.arange(T)[None], hyp2] += 10.0
    got.add_batch_logits(gt2, torch.from_numpy(logits))
    ref.add_batch_logits(gt2, logits)
    out = got.compute()
    assert_dicts(out, ref.compute())
    assert out["bleu1"] > 0 and out["cider"] > 0
