"""Corpus BLEU matching the HF `datasets` "bleu" metric the reference uses.

The reference computes BLEU-1..4 via ``datasets.load_metric('bleu')``
(the reference's utils.py:251-260), which wraps the tensor2tensor
``compute_bleu`` routine (Papineni et al. 2002 with per-order clipped
counts, geometric mean, and brevity penalty using the *shortest* reference
length per segment).  This is a fresh implementation of that algorithm.

The port's own copy of ``captionax/eval/bleu.py`` (pure Python; importing
anything of captionax runs its package init, which imports JAX).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Sequence


def _ngrams(tokens: Sequence[str], max_order: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_order + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def corpus_bleu(
    predictions: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_order: int = 4,
    smooth: bool = False,
) -> Dict[str, object]:
    """BLEU over tokenized predictions and per-segment reference lists.

    Returns the same dict fields as the HF metric: ``bleu``, ``precisions``,
    ``brevity_penalty``, ``length_ratio``, ``translation_length``,
    ``reference_length``.
    """
    matches = [0] * max_order
    possible = [0] * max_order
    translation_length = 0
    reference_length = 0

    for pred, refs in zip(predictions, references):
        translation_length += len(pred)
        reference_length += min(len(r) for r in refs)

        merged_ref: Counter = Counter()
        for r in refs:
            merged_ref |= _ngrams(r, max_order)
        overlap = _ngrams(pred, max_order) & merged_ref
        for ngram, cnt in overlap.items():
            matches[len(ngram) - 1] += cnt
        for n in range(1, max_order + 1):
            if len(pred) - n + 1 > 0:
                possible[n - 1] += len(pred) - n + 1

    precisions = [0.0] * max_order
    for n in range(max_order):
        if smooth:
            precisions[n] = (matches[n] + 1.0) / (possible[n] + 1.0)
        elif possible[n] > 0:
            precisions[n] = matches[n] / possible[n]

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0

    ratio = translation_length / reference_length if reference_length else 0.0
    if ratio > 1.0:
        bp = 1.0
    elif ratio > 0.0:
        bp = math.exp(1 - 1.0 / ratio)
    else:
        bp = 0.0

    return {
        "bleu": geo_mean * bp,
        "precisions": precisions,
        "brevity_penalty": bp,
        "length_ratio": ratio,
        "translation_length": translation_length,
        "reference_length": reference_length,
    }
