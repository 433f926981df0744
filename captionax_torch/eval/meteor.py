"""METEOR matching the HF `datasets` "meteor" metric the reference uses.

HF "meteor" wraps ``nltk.translate.meteor_score.meteor_score`` with
``alpha=0.9, beta=3, gamma=0.5`` (the reference's utils.py:261-263).  This is
a fresh implementation of that algorithm: greedy word alignment in stages
(exact match, Porter-stem match, WordNet-synonym match), unigram
precision/recall f-mean, and a fragmentation penalty over contiguous match
chunks.  The WordNet stage is used when the corpus data is installed and
skipped otherwise; exact and stem stages dominate caption-length text, so
scores differ only marginally.  The stem stage needs nltk's Porter stemmer
(pure code); where nltk does not import, words are matched unstemmed.

The port's own copy of ``captionax/eval/meteor.py`` (pure Python; importing
anything of captionax runs its package init, which imports JAX).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Set, Tuple

try:  # pure-code stemmer, no nltk data needed
    from nltk.stem.porter import PorterStemmer

    _STEM = PorterStemmer().stem
except Exception:  # pragma: no cover
    _STEM = lambda w: w  # noqa: E731

_WORDNET = None


def _get_wordnet():
    global _WORDNET
    if _WORDNET is None:
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("test")  # force the lazy corpus load
            _WORDNET = wordnet
        except Exception:
            _WORDNET = False
    return _WORDNET


def _match_stage(
    hyp: List[Tuple[int, str]],
    ref: List[Tuple[int, str]],
    key: Callable[[str], object],
) -> Tuple[List[Tuple[int, int]], List, List]:
    """Greedy first-available matching of enumerated word lists under `key`
    (the nltk _match_enums/_enum_stem_match strategy)."""
    matches = []
    rem_hyp = list(hyp)
    rem_ref = list(ref)
    i = 0
    while i < len(rem_hyp):
        matched = False
        hk = key(rem_hyp[i][1])
        for j in range(len(rem_ref)):
            if hk == key(rem_ref[j][1]):
                matches.append((rem_hyp[i][0], rem_ref[j][0]))
                del rem_hyp[i]
                del rem_ref[j]
                matched = True
                break
        if not matched:
            i += 1
    return matches, rem_hyp, rem_ref


def _make_wordnet_syns(wordnet) -> Callable[[str], Set[str]]:
    def syns(word: str) -> Set[str]:
        lemmas = set()
        for ss in wordnet.synsets(word):
            for lemma in ss.lemmas():
                if "_" not in lemma.name():
                    lemmas.add(lemma.name())
        lemmas.add(word)
        return lemmas

    return syns


def _wordnet_stage(hyp, ref, syns):
    """Greedy matching where words match if ref's word is in the
    hypothesis word's synonym set (``syns(word) -> set`` — the real
    WordNet corpus when installed, or a user-supplied table such as
    captionax_torch.eval.wordnet_lite.lite_syns)."""
    matches = []
    rem_hyp = list(hyp)
    rem_ref = list(ref)
    i = 0
    while i < len(rem_hyp):
        matched = False
        hs = syns(rem_hyp[i][1])
        for j in range(len(rem_ref)):
            if rem_ref[j][1] in hs:
                matches.append((rem_hyp[i][0], rem_ref[j][0]))
                del rem_hyp[i]
                del rem_ref[j]
                matched = True
                break
        if not matched:
            i += 1
    return matches, rem_hyp, rem_ref


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    """Number of contiguous aligned runs among the (hyp_idx, ref_idx) pairs."""
    if not matches:
        return 0
    matches = sorted(matches)
    chunks = 1
    for k in range(1, len(matches)):
        if not (
            matches[k][0] == matches[k - 1][0] + 1
            and matches[k][1] == matches[k - 1][1] + 1
        ):
            chunks += 1
    return chunks


def meteor_score(
    prediction: Sequence[str] | str,
    reference: Sequence[str] | str,
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    synonyms: Optional[Callable[[str], Set[str]]] = None,
) -> float:
    """Single-reference METEOR.  Accepts strings or pre-split token lists.

    ``synonyms``: optional ``word -> set-of-synonyms`` for the stage-3
    match when the real WordNet corpus is absent (e.g.
    captionax_torch.eval.wordnet_lite.lite_syns — a curated caption-domain
    approximation; see benchmarks/meteor_wordnet_delta.py for its
    measured effect).  The installed nltk WordNet takes precedence."""
    hyp_words = prediction.split() if isinstance(prediction, str) else list(prediction)
    ref_words = reference.split() if isinstance(reference, str) else list(reference)
    hyp = list(enumerate(hyp_words))
    ref = list(enumerate(ref_words))

    matches, hyp, ref = _match_stage(hyp, ref, lambda w: w)
    stem_matches, hyp, ref = _match_stage(hyp, ref, _STEM)
    matches += stem_matches
    wordnet = _get_wordnet()
    syns = _make_wordnet_syns(wordnet) if wordnet else synonyms
    if syns is not None and hyp and ref:
        wn_matches, hyp, ref = _wordnet_stage(hyp, ref, syns)
        matches += wn_matches

    m = len(matches)
    if m == 0 or not hyp_words or not ref_words:
        return 0.0
    precision = m / len(hyp_words)
    recall = m / len(ref_words)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    penalty = gamma * frag**beta
    return (1 - penalty) * fmean


def meteor_corpus(
    predictions: Sequence[str], references: Sequence[str], **kw
) -> float:
    """Mean single-reference METEOR over parallel string lists (the HF
    metric averages per-pair scores)."""
    if not predictions:
        return 0.0
    return sum(
        meteor_score(h, r, **kw) for h, r in zip(predictions, references)
    ) / len(predictions)
