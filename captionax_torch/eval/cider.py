"""CIDEr (Consensus-based Image Description Evaluation), corpus-df mode.

A fresh implementation of the metric from Vedantam et al. (arXiv:1411.5726)
that is *score-equivalent* to the coco-caption scorer vendored by the
reference (its cider.py and cider_scorer.py) — that
vendored copy defines parity, so we reproduce its exact behavior including
its quirks:

- document frequency is computed **over the evaluation batch itself**
  (corpus mode): df[ngram] = number of images whose reference set contains
  the ngram (cider_scorer.py:104-115);
- the idf log-ref-length is ``log(num_images)`` (cider_scorer.py:171-172);
- tf-idf weight = tf * (ref_len - log(max(1, df)));
- per-n cosine similarity between hyp and each ref, **no** length/gaussian
  penalty (the vendored ``sim`` computes ``delta`` but never applies it);
- per-image score = mean over n of (sum over refs of cosine) / num_refs * 10.

Because df depends on the whole batch, callers must present the same batch
composition as the reference to get identical numbers (SURVEY.md §7.3).

The port's own copy of ``captionax/eval/cider.py`` (pure Python; importing
anything of captionax runs its package init, which imports JAX).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _ngram_counts(sentence: str, n_max: int = 4) -> Counter:
    """Counter of 1..n_max-gram tuples of a whitespace-tokenized sentence."""
    words = sentence.split()
    counts: Counter = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts


def cider_score(
    hypotheses: Sequence[str],
    references: Sequence[Sequence[str]],
    n_max: int = 4,
) -> Tuple[float, np.ndarray]:
    """Corpus-mode CIDEr. Returns (mean score, per-image scores)."""
    assert len(hypotheses) == len(references)
    num_images = len(hypotheses)
    if num_images == 0:
        return 0.0, np.zeros((0,))

    ref_counts: List[List[Counter]] = [
        [_ngram_counts(r, n_max) for r in refs] for refs in references
    ]
    hyp_counts: List[Counter] = [_ngram_counts(h, n_max) for h in hypotheses]

    # batch document frequency: one count per image whose refs use the ngram
    df: Dict[tuple, float] = defaultdict(float)
    for refs in ref_counts:
        seen = set()
        for ref in refs:
            seen.update(ref.keys())
        for ngram in seen:
            df[ngram] += 1.0

    log_num = math.log(float(num_images))

    def tfidf(counts: Counter):
        """Per-n sparse tf-idf vectors and their norms."""
        vecs = [defaultdict(float) for _ in range(n_max)]
        norms = [0.0] * n_max
        for ngram, tf in counts.items():
            idf = log_num - math.log(max(1.0, df[ngram]))
            n = len(ngram) - 1
            w = float(tf) * idf
            vecs[n][ngram] = w
            norms[n] += w * w
        return vecs, [math.sqrt(x) for x in norms]

    scores = np.zeros((num_images,))
    for i in range(num_images):
        hv, hn = tfidf(hyp_counts[i])
        per_n = np.zeros((n_max,))
        for ref in ref_counts[i]:
            rv, rn = tfidf(ref)
            for n in range(n_max):
                dot = sum(w * rv[n][g] for g, w in hv[n].items() if g in rv[n])
                if hn[n] != 0.0 and rn[n] != 0.0:
                    dot /= hn[n] * rn[n]
                per_n[n] += dot
        scores[i] = per_n.mean() / len(ref_counts[i]) * 10.0
    return float(scores.mean()), scores


class Cider:
    """Reference-call-compatible wrapper (the reference's cider.py:36-61).

    ``gts`` maps image_id -> list of reference strings; ``res`` is a list of
    ``{'image_id': id, 'caption': [hyp string]}`` records.
    """

    def __init__(self, n: int = 4, df: str = "corpus"):
        if df != "corpus":
            raise NotImplementedError("only corpus-mode df is supported")
        self._n = n

    def compute_score(self, gts, res) -> Tuple[float, np.ndarray]:
        hyps, refs = [], []
        for rec in res:
            hypo = rec["caption"]
            assert isinstance(hypo, list) and len(hypo) == 1
            ref = gts[rec["image_id"]]
            assert isinstance(ref, list) and len(ref) > 0
            hyps.append(hypo[0])
            refs.append(ref)
        return cider_score(hyps, refs, self._n)

    def method(self) -> str:
        return "CIDEr"
