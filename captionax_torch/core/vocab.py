"""Vocabulary with reference-identical token/id semantics.

The port's own copy of ``captionax/core/vocab.py`` (importing anything of
captionax runs its package init, which imports JAX).

Mirrors the reference ``Vocab`` (the reference's build_vocab.py:7-56): special
tokens ``<pad> <s> </s> <unk>`` at ids 0-3 and the FlickrStyle style words
``factual humorous romantic`` at ids 4-6, followed by corpus words in
first-seen order; factual-corpus words are filtered by min count 2.  Unknown
lookups map to ``<unk>``.  The shipped ``data/vocab.pkl`` (9,684 entries) can
be loaded via :func:`load_vocab_pickle`, which reads its ``Vocab`` (pickled
against ``__main__.Vocab``), captionax's and the port's as this module's.
"""

from __future__ import annotations

import pickle
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

from captionax_torch.core.tokenize import word_tokenize

PAD, BOS, EOS, UNK = "<pad>", "<s>", "</s>", "<unk>"
SPECIAL_TOKENS = (PAD, BOS, EOS, UNK)
STYLE_TOKENS = ("factual", "humorous", "romantic")

PAD_ID, BOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3


class Vocab:
    """word <-> id bidirectional map with ``<unk>`` fallback."""

    def __init__(self):
        self.w2i: Dict[str, int] = {}
        self.i2w: Dict[int, str] = {}
        self.ix = 0

    def add_word(self, word: str) -> None:
        if word not in self.w2i:
            self.w2i[word] = self.ix
            self.i2w[self.ix] = word
            self.ix += 1

    def __call__(self, word: str) -> int:
        return self.w2i.get(word, self.w2i[UNK])

    def __len__(self) -> int:
        return len(self.w2i)

    # -- conveniences the reference lacks ------------------------------
    def encode(self, text_or_tokens, add_bos_eos: bool = True) -> List[int]:
        """Caption string/tokens -> id list, mirroring the dataset encoding
        at the reference's data_loader.py:91-97 (strip '.', lowercase,
        tokenize, wrap in <s>...</s>)."""
        if isinstance(text_or_tokens, str):
            tokens = word_tokenize(re.sub(r"\.", "", text_or_tokens).lower())
        else:
            tokens = list(text_or_tokens)
        ids = [self(t) for t in tokens]
        if add_bos_eos:
            return [self(BOS)] + ids + [self(EOS)]
        return ids

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> List[str]:
        """id sequence -> word list, skipping <pad>/<s>, stopping at </s>
        (the ``cap_to_text_gt`` semantics, the reference's utils.py:177-190)."""
        words = []
        for i in ids:
            w = self.i2w.get(int(i), UNK)
            if w in (PAD, BOS):
                continue
            if stop_at_eos and w == EOS:
                break
            words.append(w)
        return words


def build_vocab(
    factual_captions: Optional[Iterable[str]] = None,
    styled_captions: Sequence[Iterable[str]] = (),
    min_count_factual: int = 2,
) -> Vocab:
    """Build a vocabulary from caption text.

    Reference semantics (the reference's build_vocab.py:29-56): specials +
    style words first; factual words are concatenated into one corpus string,
    tokenized, and kept if count >= 2 in **first-seen order of the Counter**;
    styled corpora contribute every token.  Caption lines should already have
    image-name prefixes removed; we strip periods and lowercase here, same as
    ``extract_captions``.
    """
    vocab = Vocab()
    for tok in SPECIAL_TOKENS + STYLE_TOKENS:
        vocab.add_word(tok)

    def corpus_tokens(lines: Iterable[str]) -> List[str]:
        text = " ".join(line.replace(".", "").strip() for line in lines)
        return word_tokenize(text.strip().lower())

    if factual_captions is not None:
        counter = Counter(corpus_tokens(factual_captions))
        for word, cnt in counter.items():
            if cnt >= min_count_factual:
                vocab.add_word(word)
    for styled in styled_captions:
        for word in corpus_tokens(styled):
            vocab.add_word(word)
    return vocab


def extract_factual_caption_lines(path: str) -> List[str]:
    """Read a FlickrStyle factual file (``name.jpg#k\\tcaption``) and return
    caption strings with the image-name prefix removed
    (the reference's build_vocab.py:62-71)."""
    r = re.compile(r"\d*.jpg#\d*")
    out = []
    with open(path, "r") as f:
        for line in f:
            out.append(r.sub("", line))
    return out


class _VocabUnpickler(pickle.Unpickler):
    """Reads a vocab pickle of any package: a class named ``Vocab``, from
    whatever module it was pickled against (``__main__`` for the shipped
    vocab.pkl, ``build_vocab``, ``captionax.core.vocab``, this module), is
    read as this module's, so that no other package is imported."""

    def find_class(self, module: str, name: str):
        if name == "Vocab":
            return Vocab
        return super().find_class(module, name)


def load_vocab_pickle(path: str) -> Vocab:
    """Load a vocab pickle (the reference's, captionax's or the port's) and
    rewrap it as our Vocab."""
    with open(path, "rb") as f:
        raw = _VocabUnpickler(f).load()
    vocab = Vocab()
    vocab.w2i = dict(raw.w2i)
    vocab.i2w = {int(k): v for k, v in raw.i2w.items()}
    vocab.ix = int(raw.ix)
    return vocab
