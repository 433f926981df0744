"""Batch caption metrics with reference ``metric_score`` semantics.

The port's own copy of ``captionax/eval/metrics.py``: decode gt/pred token
ids to text via the vocab (skipping ``<pad>``/``<s>``, stopping at
``</s>``; predictions are argmaxed logits), then compute BLEU-1..4,
METEOR, ROUGE-L and corpus-mode CIDEr over the batch.  The harness runs
these on accumulated eval decodes, off the train step's path.

CIDEr comes from the Python :func:`cider_score` (captionax's ``_assemble``
takes it from its native scorer, which agrees with the Python one to
~1e-9; the port's native loader is still to come).  Inputs may be numpy
arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from captionax_torch.eval.bleu import corpus_bleu
from captionax_torch.eval.cider import cider_score
from captionax_torch.eval.meteor import meteor_corpus
from captionax_torch.eval.rouge import rouge_l_corpus


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _argmax_ids(logits) -> np.ndarray:
    """argmax over the vocab axis, ties to the first index (as numpy's);
    a tensor's is taken on its own device, so only the ids cross to the host."""
    if hasattr(logits, "detach"):
        return _host(logits.detach().argmax(dim=-1))
    return np.asarray(logits).argmax(axis=-1)


def ids_to_text(ids: Sequence[int], vocab, tokenized: bool = False):
    """``cap_to_text_gt`` semantics: skip ``<pad>``/``<s>``, stop at ``</s>``."""
    words = vocab.decode(ids)
    return words if tokenized else " ".join(words)


def logits_to_text(logits, vocab, tokenized: bool = False):
    """``cap_to_text`` semantics: argmax over the vocab axis, then decode."""
    ids = _argmax_ids(logits)
    return ids_to_text(ids, vocab, tokenized)


def clean_sentence(ids: Sequence[int], vocab) -> str:
    """``clean_sentence`` semantics: drop ``<s>``, ``,``, ``<pad>``,
    ``</s>`` but do NOT stop at ``</s>``."""
    words = [vocab.i2w.get(int(i)) for i in ids]
    words = [w for w in words if w not in ("<s>", ",", "<pad>", "</s>")]
    return " ".join(w for w in words if w is not None)


def _bleu_suite(
    tok_hyps: List[List[str]], tok_refs: List[List[List[str]]]
) -> List[float]:
    return [
        corpus_bleu(tok_hyps, tok_refs, max_order=k)["bleu"] for k in (1, 2, 3, 4)
    ]


def metric_score(gt_caps, pred_logits, vocab) -> Dict[str, float]:
    """Batch metrics on teacher-forced logits vs gt ids.

    gt_caps: [B, T] int ids; pred_logits: [B, T, V] float logits.
    Returns {'bleu1'..'bleu4', 'meteor', 'rougeL', 'cider'}.
    """
    gt_caps = _host(gt_caps)
    pred_ids = _argmax_ids(pred_logits)
    tok_hyps, tok_refs, hyp_strs, ref_strs = [], [], [], []
    for i in range(len(pred_ids)):
        hyp = vocab.decode(pred_ids[i])
        ref = vocab.decode(gt_caps[i])
        tok_hyps.append(hyp)
        tok_refs.append([ref])
        hyp_strs.append(" ".join(hyp))
        ref_strs.append(" ".join(ref))
    return _assemble(tok_hyps, tok_refs, hyp_strs, ref_strs)


def metric_score_test(gt_caps, pred_ids: Sequence[int], vocab) -> Dict[str, float]:
    """Single decoded hypothesis (e.g. the best beam) vs a batch of gt refs
    (each ref is scored as its own image against the same hypothesis)."""
    gt_caps = _host(gt_caps)
    hyp = vocab.decode(_host(pred_ids))
    hyp_str = " ".join(hyp)
    tok_hyps, tok_refs, hyp_strs, ref_strs = [], [], [], []
    for i in range(len(gt_caps)):
        ref = vocab.decode(gt_caps[i])
        tok_hyps.append(hyp)
        tok_refs.append([ref])
        hyp_strs.append(hyp_str)
        ref_strs.append(" ".join(ref))
    return _assemble(tok_hyps, tok_refs, hyp_strs, ref_strs)


def _assemble(tok_hyps, tok_refs, hyp_strs, ref_strs) -> Dict[str, float]:
    bleu = _bleu_suite(tok_hyps, tok_refs)
    cider_refs = [[" ".join(r[0])] for r in tok_refs]
    cider_hyps = [" ".join(h) for h in tok_hyps]
    cider, _ = cider_score(cider_hyps, cider_refs)
    return {
        "bleu1": bleu[0],
        "bleu2": bleu[1],
        "bleu3": bleu[2],
        "bleu4": bleu[3],
        "meteor": meteor_corpus(hyp_strs, ref_strs),
        "rougeL": rouge_l_corpus(hyp_strs, ref_strs),
        "cider": cider,
    }


class CaptionMetrics:
    """Stateful accumulator for eval loops: add batches, compute once
    (CIDEr's document frequencies are taken over the accumulated corpus)."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.tok_hyps: List[List[str]] = []
        self.tok_refs: List[List[List[str]]] = []
        self.hyp_strs: List[str] = []
        self.ref_strs: List[str] = []

    def add_batch_ids(self, gt_caps, pred_ids) -> None:
        gt_caps = _host(gt_caps)
        pred_ids = _host(pred_ids)
        for i in range(len(pred_ids)):
            hyp = self.vocab.decode(pred_ids[i])
            ref = self.vocab.decode(gt_caps[i])
            self.tok_hyps.append(hyp)
            self.tok_refs.append([ref])
            self.hyp_strs.append(" ".join(hyp))
            self.ref_strs.append(" ".join(ref))

    def add_batch_logits(self, gt_caps, pred_logits) -> None:
        self.add_batch_ids(gt_caps, _argmax_ids(pred_logits))

    def compute(self) -> Dict[str, float]:
        if not self.tok_hyps:
            return {k: 0.0 for k in
                    ("bleu1", "bleu2", "bleu3", "bleu4", "meteor", "rougeL", "cider")}
        return _assemble(self.tok_hyps, self.tok_refs, self.hyp_strs, self.ref_strs)
