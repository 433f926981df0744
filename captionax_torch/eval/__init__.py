"""Evaluation helpers of the port (its own copies; nothing of captionax)."""

from captionax_torch.eval.ptbtok import PTBTokenizer, ptb_tokenize

__all__ = ["PTBTokenizer", "ptb_tokenize"]
