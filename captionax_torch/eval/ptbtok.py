"""PTB tokenization for caption evaluation.

The port's own copy of ``captionax/eval/ptbtok.py``.  The reference's
coco-caption code shells out to the Stanford CoreNLP ``PTBTokenizer`` jar,
an optional Java subprocess whose jar is not vendored.  This module has a
pure-Python tokenizer with the same observable behaviour on caption text
(Treebank word rules, lowercased, with the coco-caption punctuation list
removed), and keeps the Java subprocess as an optional backend when a jar
path is given and exists.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Dict, List

from captionax_torch.core.tokenize import word_tokenize

# coco-caption's PUNCTUATIONS (its ptbtokenizer.py)
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]


def ptb_tokenize(text: str) -> List[str]:
    """Tokenize one caption: Treebank rules, lowercase, drop punctuation."""
    toks = word_tokenize(text.lower())
    # Treebank emits brackets literally; map to PTB tags so the same
    # punctuation list removes them.
    remap = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-"}
    toks = [remap.get(t, t) for t in toks]
    return [t for t in toks if t not in PUNCTUATIONS]


class PTBTokenizer:
    """coco-caption-compatible batch tokenizer.

    ``tokenize`` takes ``{image_id: [{'caption': str}, ...]}`` and returns
    ``{image_id: [tokenized_caption_str, ...]}`` like the reference class.
    """

    def __init__(self, corenlp_jar: str | None = None):
        self.corenlp_jar = corenlp_jar

    def tokenize(self, captions_for_image: Dict) -> Dict[object, List[str]]:
        if self.corenlp_jar and os.path.exists(self.corenlp_jar):
            return self._tokenize_java(captions_for_image)
        out: Dict[object, List[str]] = {}
        for image_id, entries in captions_for_image.items():
            out[image_id] = [
                " ".join(ptb_tokenize(entry["caption"])) for entry in entries
            ]
        return out

    def _tokenize_java(self, captions_for_image: Dict) -> Dict[object, List[str]]:
        image_ids = [
            k for k, entries in captions_for_image.items() for _ in entries
        ]
        sentences = "\n".join(
            entry["caption"].replace("\n", " ")
            for entries in captions_for_image.values()
            for entry in entries
        )
        cmd = [
            "java", "-cp", self.corenlp_jar,
            "edu.stanford.nlp.process.PTBTokenizer",
            "-preserveLines", "-lowerCase",
        ]
        with tempfile.NamedTemporaryFile("w", delete=False) as f:
            f.write(sentences)
            path = f.name
        try:
            with open(path) as fin:
                proc = subprocess.run(
                    cmd, stdin=fin, capture_output=True, text=True, check=True
                )
            lines = proc.stdout.split("\n")
        finally:
            os.remove(path)
        out: Dict[object, List[str]] = {k: [] for k in captions_for_image}
        for image_id, line in zip(image_ids, lines):
            toks = [w for w in line.rstrip().split() if w not in PUNCTUATIONS]
            out[image_id].append(" ".join(toks))
        return out
