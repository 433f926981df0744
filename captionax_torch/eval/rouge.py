"""ROUGE-L matching the HF `datasets` "rouge" metric the reference uses.

The reference reads ``metric.compute()['rougeL'][1][2]`` — the *mid
f-measure* of google-research ``rouge_score`` with the bootstrap aggregator
(the reference's utils.py:264-266).  The bootstrap median of per-pair
f-measures converges to their mean; we return the exact per-pair scores and
their mean (deterministic), which matches the reference to well within its
own bootstrap noise.

Tokenization matches ``rouge_score``: lowercase, replace non-alphanumerics
with spaces, split.

The port's own copy of ``captionax/eval/rouge.py`` (pure Python; importing
anything of captionax runs its package init, which imports JAX).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple


def _rouge_tokenize(text: str) -> List[str]:
    text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    return [t for t in text.split() if t]


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = cur[j - 1] if cur[j - 1] >= prev[j] else prev[j]
        prev = cur
    return prev[len(b)]


def rouge_l(prediction: str, reference: str) -> Tuple[float, float, float]:
    """(precision, recall, fmeasure) of ROUGE-L for one pair of strings."""
    hyp = _rouge_tokenize(prediction)
    ref = _rouge_tokenize(reference)
    lcs = _lcs_len(hyp, ref)
    if lcs == 0:
        return 0.0, 0.0, 0.0
    p = lcs / len(hyp)
    r = lcs / len(ref)
    f = 2 * p * r / (p + r)
    return p, r, f


def rouge_l_corpus(
    predictions: Sequence[str], references: Sequence[str]
) -> float:
    """Mean ROUGE-L f-measure over parallel prediction/reference strings."""
    if not predictions:
        return 0.0
    total = 0.0
    for hyp, ref in zip(predictions, references):
        total += rouge_l(hyp, ref)[2]
    return total / len(predictions)
