"""Training losses.

Port of ``captionax/train/losses.py``.  ``cross_entropy_loss`` is the
reference objective ``F.cross_entropy(logits.view(-1, V), caps.view(-1),
ignore_index=<pad>)``: the mean over non-pad positions.
``fused_ce_from_hidden`` computes the same value from the hidden states in
row chunks, without building the [B*T, V] logits.
``label_smoothing_loss`` is the LaBERT baseline's LabelSmoothingLoss.

Each loss is a mean over the whole batch's tokens.  Inside a data-parallel
step (``parallel/mesh.py``'s ``data_parallel``) a rank holds a shard of the
batch, and its loss divides its own sum by the count of every rank's
tokens (``global_sum``): the ranks' losses then sum to the whole batch's,
and their gradients, summed, to its gradient, whatever the number of
non-pad tokens in each shard.  Outside such a step ``global_sum`` is the
identity.

The vocab product of the fused loss is one large matrix product, which the
JAX package leaves to XLA; here it is ``torch.matmul`` in f32 (from the
bf16 values under bf16 compute), as ``preferred_element_type=float32``
asks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from captionax_torch.parallel.mesh import global_mean, global_sum


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       pad_id: Optional[int] = 0) -> torch.Tensor:
    """logits [..., V] float, targets [...] int.  Mean CE over non-pad.

    ``pad_id=None`` disables masking: the mean over all positions."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if pad_id is None:
        return global_mean(nll)
    mask = (targets != pad_id).to(nll.dtype)
    denom = torch.clamp(global_sum(mask.sum()), min=1.0)
    return (nll * mask).sum() / denom


def _chunk_ce(hc, tc, w, b, pad_id):
    """(sum of nll over non-pad rows, count of non-pad rows) of one chunk."""
    logits = torch.matmul(hc.float(), w.float()) + b.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[:, None])[:, 0]
    mask = (tc != pad_id).float()
    return ((lse - tgt) * mask).sum(), mask.sum()


def fused_ce_from_hidden(fc: dict, hs: torch.Tensor, targets: torch.Tensor,
                         pad_id: int = 0, chunk_rows: int = 2048,
                         remat: bool = True) -> torch.Tensor:
    """``cross_entropy_loss(linear(fc, hs), targets, pad_id)`` in chunks of
    ``chunk_rows`` rows: each chunk runs one [C, H] x [H, V] product and is
    reduced to (sum of nll, count) at once; with ``remat`` its backward
    recomputes the chunk's logits instead of keeping them.  Rows that pad
    the last chunk get ``pad_id`` targets and drop out of the mean."""
    H = hs.shape[-1]
    h2 = hs.reshape(-1, H)
    t1 = targets.reshape(-1).long()
    n = h2.shape[0]
    c = min(chunk_rows, n)
    n_pad = -(-n // c) * c
    if n_pad != n:
        h2 = F.pad(h2, (0, 0, 0, n_pad - n))
        t1 = F.pad(t1, (0, n_pad - n), value=pad_id)
    w, b = fc["w"], fc["b"]
    num = torch.zeros((), dtype=torch.float32, device=hs.device)
    den = torch.zeros((), dtype=torch.float32, device=hs.device)
    for i in range(0, n_pad, c):
        args = (h2[i:i + c], t1[i:i + c], w, b, pad_id)
        if remat:
            s, m = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            s, m = _chunk_ce(*args)
        num = num + s
        den = den + m
    return num / torch.clamp(global_sum(den), min=1.0)


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1, pad_id: int = 0) -> torch.Tensor:
    """KL(smoothed one-hot || softmax), averaged over non-pad positions."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    onehot = F.one_hot(targets.long(), V).to(logits.dtype)
    true_dist = onehot * confidence + (1.0 - onehot) * low
    nll = -(true_dist * logp).sum(dim=-1)
    mask = (targets != pad_id).to(nll.dtype)
    denom = torch.clamp(global_sum(mask.sum()), min=1.0)
    return (nll * mask).sum() / denom


def mixup_style_target(coeff: torch.Tensor, missing_style: int) -> torch.Tensor:
    """3-way mixup target of the style-classifier loss, styles [factual,
    humour, romantic]: the missing style gets 0, the other two ``coeff``
    and ``1 - coeff``."""
    coeff = torch.as_tensor(coeff)
    zero = torch.zeros_like(coeff)
    rows = torch.stack([
        torch.stack([zero, coeff, 1 - coeff]),
        torch.stack([coeff, zero, 1 - coeff]),
        torch.stack([coeff, 1 - coeff, zero]),
    ])
    return rows[missing_style]
