"""Fixed-shape batched decoding in plain PyTorch: greedy, sampling, k-beam.

Port of ``greedy``, ``sample``, ``beam_search`` and ``BeamResult`` from
``captionax/decode/search.py``.  ``greedy`` and ``sample`` start from token
0 with its embedding (not zeroed), emit ``<pad>`` (0) once a row has
emitted ``</s>``, and keep a finished row's hidden state and token.
``sample`` draws ``argmax(logits / temperature + gumbel)``, which is what
``jax.random.categorical`` computes, with the Gumbel noise from
:func:`_gumbel` and an explicit ``torch.Generator``.

``beam_search`` keeps the reference ``test_step`` semantics:

- beams start from token 0 with a zeroed embedding at step 1;
- step 1 expands beam 0 only (the other beams start at -1e9);
- cumulative log-softmax scores, top-k over the flattened k*V candidates
  with ties to the first occurrence, as ``lax.top_k``;
- a beam that emits ``</s>`` is recorded as complete and leaves
  contention; the winner is the completion with the best raw (or
  length-normalised) score, kept by strict improvement.

``greedy`` and ``beam_search`` run every step (no early exit): they are
the port's in-package oracles for the fused greedy and beam kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.interop import to_device
from captionax_torch.models import decoder as dec
from captionax_torch.models.layers import embedding

NEG_INF = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_steps + 1] incl. the leading start token 0
    scores: torch.Tensor   # [B] winning cumulative (or normalised) score
    found: torch.Tensor    # [B] bool: did any beam complete
    lengths: torch.Tensor  # [B] tokens of the winner incl. leading 0 and </s>


def top_k_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of [N, M] in descending order, ties to the lowest
    index (``lax.top_k``'s order; ``torch.topk`` does not promise one)."""
    cols = torch.arange(x.shape[1], device=x.device).expand_as(x)
    vals, idxs = [], []
    for _ in range(k):
        v = x.max(dim=1).values
        i = torch.where(x >= v[:, None], cols, x.shape[1]).min(dim=1).values
        vals.append(v)
        idxs.append(i)
        x = torch.where(cols == i[:, None], torch.full_like(x, float("-inf")), x)
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def _free_running(params: Dict, features: torch.Tensor, gru_params: Optional[Dict],
                  max_len: int, end_id: int,
                  pick: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The greedy / sampling loop: ``pick`` maps logits [B, V] to the next
    tokens [B].  -> int32 token ids [B, max_len]."""
    B = features.shape[0]
    dev = features.device
    h = dec.init_hidden(params, features)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
    for t in range(max_len):
        h_new, logits, _ = dec.decode_step(params, embedding(params["embed"], tok), h,
                                           features, gru_params)
        nxt = pick(logits)
        out[:, t] = torch.where(done, torch.zeros_like(nxt), nxt).to(torch.int32)
        h = torch.where(done[:, None], h, h_new)
        tok = torch.where(done, tok, nxt)
        done = done | (nxt == end_id)
    return out


def _prepare(params, raw_features, gru_params, device):
    """Params, theta and raw features on the decode device; the features
    encoded by the decoder's feature MLP."""
    dev = resolve_device(device)
    params = to_device(params, dev)
    gru_params = None if gru_params is None else to_device(gru_params, dev)
    features = dec.encode_features(params, torch.as_tensor(raw_features).to(dev))
    return params, features, gru_params


def greedy(
    params: Dict,
    raw_features: torch.Tensor,
    max_len: int = 20,
    end_id: int = 2,
    gru_params: Optional[Dict] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Batched greedy decode: the first argmax of ``log_softmax(logits)``
    at every step.  -> int32 token ids [B, max_len]; positions after
    ``</s>`` are ``<pad>``.  ``gru_params`` may be shared or carry a
    leading [B] axis (one theta per image)."""
    params, features, gru_params = _prepare(params, raw_features, gru_params, device)
    return _free_running(
        params, features, gru_params, max_len, end_id,
        lambda logits: torch.argmax(torch.log_softmax(logits, dim=-1), dim=-1))


def _gumbel(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample(
    params: Dict,
    raw_features: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_len: int = 20,
    end_id: int = 2,
    temperature: float = 1.0,
    top_k: int = 0,
    gru_params: Optional[Dict] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Batched multinomial sampling from ``softmax(logits / temperature)``,
    restricted to the ``top_k`` largest logits when ``top_k > 0``.  The
    noise comes from ``generator`` (on the decode device).  -> int32 token
    ids [B, max_len]."""
    params, features, gru_params = _prepare(params, raw_features, gru_params, device)
    dev = features.device

    def pick(logits):
        logits = logits / temperature
        if top_k > 0:
            vals, idx = top_k_first(logits, top_k)
            choice = torch.argmax(_gumbel(generator, vals.shape, dev) + vals, dim=-1)
            return torch.gather(idx, 1, choice[:, None])[:, 0]
        return torch.argmax(_gumbel(generator, logits.shape, dev) + logits, dim=-1)

    return _free_running(params, features, gru_params, max_len, end_id, pick)


def beam_search(
    params: Dict,
    raw_features: torch.Tensor,
    k: int = 3,
    max_steps: int = 50,
    end_id: int = 2,
    length_norm: bool = False,
    gru_params: Optional[Dict] = None,
    device: DeviceLike = None,
) -> BeamResult:
    """raw_features [B, R, NF] -> BeamResult.  ``gru_params`` may be shared
    or carry a leading [B] axis (one theta per image)."""
    params, features, gru_params = _prepare(params, raw_features, gru_params, device)
    dev = features.device
    B, R, F = features.shape
    V = params["fc"]["b"].shape[0]
    T = max_steps + 1

    feats_bk = features.repeat_interleave(k, dim=0)
    if gru_params is not None and gru_params["w_ih"].dim() == 3:
        gru_bk = {n: t.repeat_interleave(k, dim=0) for n, t in gru_params.items()}
    else:
        gru_bk = gru_params

    h = dec.init_hidden(params, feats_bk)
    H = h.shape[1]
    tokens = torch.zeros((B, k, T), dtype=torch.int32, device=dev)
    scores = torch.full((B, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    prev_tok = torch.zeros((B, k), dtype=torch.long, device=dev)
    best_score = torch.full((B,), NEG_INF, device=dev)
    best_seq = torch.zeros((B, T), dtype=torch.int32, device=dev)
    best_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)

    for t in range(max_steps):
        emb = embedding(params["embed"], prev_tok.reshape(B * k))
        if t == 0:
            emb = torch.zeros_like(emb)
        h_new, logits, _ = dec.decode_step(params, emb, h, feats_bk, gru_bk)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, k, V)

        cand = scores[:, :, None] + logp
        top_scores, top_idx = top_k_first(cand.reshape(B, k * V), k)
        prev_beam = top_idx // V
        next_tok = top_idx % V

        tokens = tokens[rows[:, None], prev_beam]
        tokens[:, :, t + 1] = next_tok.to(torch.int32)
        h = h_new.reshape(B, k, H)[rows[:, None], prev_beam].reshape(B * k, H)

        alive_parent = top_scores > NEG_INF / 2
        completed = (next_tok == end_id) & alive_parent
        crit = top_scores / (t + 2.0) if length_norm else top_scores
        cand_val = torch.where(completed, crit, torch.full_like(crit, NEG_INF))
        slot_val, best_slot = top_k_first(cand_val, 1)
        slot_val, best_slot = slot_val[:, 0], best_slot[:, 0]
        improve = slot_val > best_score
        best_score = torch.where(improve, slot_val, best_score)
        best_seq = torch.where(improve[:, None], tokens[rows, best_slot], best_seq)
        best_len = torch.where(improve, torch.full_like(best_len, t + 2), best_len)
        found = found | completed.any(dim=1)

        scores = torch.where(completed, torch.full_like(top_scores, NEG_INF),
                             top_scores)
        prev_tok = next_tok

    pos = torch.arange(T, device=dev)[None]
    best_seq = torch.where(pos < best_len[:, None], best_seq,
                           torch.zeros_like(best_seq))
    return BeamResult(best_seq, best_score, found, best_len)
