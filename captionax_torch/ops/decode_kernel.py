"""The fused decode kernels for the H100 — K1 (k=3 beam) and K2 (greedy) —
and their plain versions.

Port of ``fused_beam_search`` and ``fused_greedy`` from
``captionax/ops/decode_kernel.py``.  On the TPU one Pallas launch
(``_beam_kernel``, ``_greedy_kernel``) runs a whole decode with the weights
resident in VMEM; here a host loop issues three hand-written CUDA kernels
per step (``csrc/beam_decode.cu``, ``csrc/greedy_decode.cu``):

- :func:`cell_step`            (a) embed, attention, GRU on the theta bank,
  shared by both decodes (3 rows per image and a zero word at t=0 for the
  beam, 1 row per image and the embedding of token 0 for greedy);
- :func:`logits_top3_partial`  (b) vocab product + per-chunk top-3 and
  logsumexp partials, never the whole row of logits;
- :func:`beam_select`          (c) merge the partials, top-3 of each
  image's 9 candidates, reorder by parent, retire completions;
- :func:`logits_top1_partial`  (b1) vocab product + per-chunk maximum and
  first argmax;
- :func:`greedy_select`        (c1) merge the partials into each row's
  first argmax, emit, retire rows on ``</s>``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version beside it (``*_plain``) for CPU tensors only.  The
plain versions compute the same function, in the same order of steps, and
are what the CPU tests and the on-card comparison hold the kernels to.

Semantics held to the reference kernels: the beam's step 1 embeds zeros
and expands beam 0 only; greedy embeds token 0 at step 1; ties go to the
first occurrence (vocab order within a row, beam-major order across an
image's 9 candidates); cumulative candidate scores are
``score + (v - logz)``; completions need a live parent (``> -1e9/2``), are
kept by strict improvement with length ``t+2``; a greedy row emits 0 once
done and keeps its h and token; ``style_rows`` are clamped to ``[0, S)``;
V is padded to a multiple of 128 with a -1e9 bias.

Early exit, as the reference has it: the select kernel of step t writes a
device flag ``run[t+1]`` — for the beam, whether some row's score still
exceeds its image's best completion; for greedy, whether some row is not
done — and every kernel of step t+1 returns at entry when it is 0.  The
host issues every launch without a sync (so batches still overlap in
``PipelinedDecoder``), and the outputs equal those of a decode that runs
every step.  ``run[:steps].sum()`` is the number of steps actually run
(``last_steps`` on the decoders).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.decode.search import NEG_INF, BeamResult, top_k_first
from captionax_torch.interop import to_device
from captionax_torch.models import decoder as dec
from captionax_torch.models.layers import linear
from captionax_torch.ops._cuda import KernelOp

K = 3            # beam width the kernels are written for
CHUNK = 128      # vocab columns per partial of (b) and (b1)
TILE_ROWS = (3, 6, 12)   # rows per block of (a) that the library instantiates
TILE_IMAGES = (1, 2, 4)  # beam images per block of (a): 3, 6 or 12 rows
GREEDY_BLOCK_ROWS = 3    # rows per block of (a) for greedy: the fastest tile (PERF.md)

CELL = KernelOp("cell_step")
LOGITS = KernelOp("logits_top3_partial")
SELECT = KernelOp("beam_select")
LOGITS1 = KernelOp("logits_top1_partial")
GREEDY_SELECT = KernelOp("greedy_select")
BEAM_KERNELS = (CELL, LOGITS, SELECT)
GREEDY_KERNELS = (CELL, LOGITS1, GREEDY_SELECT)
KERNELS = (CELL, LOGITS, SELECT, LOGITS1, GREEDY_SELECT)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(t: torch.Tensor, name: str, dev: torch.device, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch_device(t: torch.Tensor) -> torch.device:
    """The CUDA device a kernel wrapper launches on; other devices raise."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device


def _runs(live: Optional[torch.Tensor]) -> bool:
    """The plain versions' gate: no flag, or this step's flag is set."""
    return live is None or bool(live[0])


def _check_live(live: Optional[torch.Tensor], dev: torch.device, n: int) -> int:
    """A kernel's gate pointer: 0 (always run) for None, else the address of
    an int32 flag array of at least ``n`` entries on ``dev``."""
    if live is None:
        return 0
    if live.device != dev or live.dtype != torch.int32 or live.dim() != 1:
        raise ValueError("live must be a 1-D int32 tensor on the launch device")
    if live.numel() < n or not live.is_contiguous():
        raise ValueError(f"live must be contiguous with at least {n} entries")
    return _ptr(live)


def _new_run(steps: int, dev: torch.device) -> torch.Tensor:
    """The early-exit flags run[steps + 1]: step 0 runs, the rest wait to be
    set by the select of the step before."""
    run = torch.zeros((steps + 1,), dtype=torch.int32, device=dev)
    run[0] = 1
    return run


# ====================================================================
# weights and features
# ====================================================================
def _pack_weights(decoder_params: Dict, gru_params: Optional[Dict],
                  weight_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Decoder params -> kernel operands, V padded to a multiple of 128 with
    a -1e9 bias.  The theta is stored as a bank of one: ``wih_t`` [1, In, 3H],
    ``whh_t`` [1, H, 3H], biases [1, 3H] in f32."""
    theta = gru_params if gru_params is not None else decoder_params["gru"]
    emb = decoder_params["embed"]
    V, E = emb.shape
    vp = _round_up(V, CHUNK)
    fc_w = decoder_params["fc"]["w"]
    H = fc_w.shape[0]
    dev = emb.device
    emb_p = torch.zeros((vp, E), dtype=weight_dtype, device=dev)
    emb_p[:V] = emb.to(weight_dtype)
    fcw_p = torch.zeros((H, vp), dtype=weight_dtype, device=dev)
    fcw_p[:, :V] = fc_w.to(weight_dtype)
    fcb_p = torch.full((vp,), NEG_INF, dtype=torch.float32, device=dev)
    fcb_p[:V] = decoder_params["fc"]["b"].float()
    att = decoder_params["attention"]
    return {
        "emb": emb_p,
        "ua_w": att["U_a"]["w"].to(weight_dtype).contiguous(),
        "ua_b": att["U_a"]["b"].float().contiguous(),
        "va": att["v_a"]["w"][:, 0].float().contiguous(),
        "wih_t": theta["w_ih"].t().to(weight_dtype).contiguous()[None],
        "whh_t": theta["w_hh"].t().to(weight_dtype).contiguous()[None],
        "bih": theta["b_ih"].float().contiguous()[None],
        "bhh": theta["b_hh"].float().contiguous()[None],
        "fc_w": fcw_p,
        "fc_b": fcb_p,
    }


def _pack_weight_bank(weights: Dict, thetas: Dict,
                      weight_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Replace the theta of a ``_pack_weights`` dict by a bank of S thetas
    (leading style axis): ``wih_t`` [S, In, 3H], ``whh_t`` [S, H, 3H],
    biases [S, 3H].  The kernel indexes the bank by each image's style."""
    weights["wih_t"] = thetas["w_ih"].transpose(1, 2).to(weight_dtype).contiguous()
    weights["whh_t"] = thetas["w_hh"].transpose(1, 2).to(weight_dtype).contiguous()
    weights["bih"] = thetas["b_ih"].float().contiguous()
    weights["bhh"] = thetas["b_hh"].float().contiguous()
    return weights


def _prep_features(decoder_params: Dict, raw_features: torch.Tensor):
    """encode the features, precompute att1 = W_a f + b_a and h0 (library
    matmuls: in the JAX package these are XLA ops outside the kernel)."""
    feats = dec.encode_features(decoder_params, raw_features)
    att1 = linear(decoder_params["attention"]["W_a"], feats)
    h0 = dec.init_hidden(decoder_params, feats)
    return feats, att1, h0


# ====================================================================
# (a) embed + attention + GRU, for beam rows and greedy rows
# ====================================================================
def cell_step_plain(feats, att1, h, tok, styles, t: int, w: Dict[str, torch.Tensor],
                    zero_word_t0: bool = True,
                    live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [rows, H] (row = image * rows_per_image + slot) -> h_new [rows, H]
    in f32; rows_per_image is rows // B (3 for beam rows, 1 for greedy)."""
    if not _runs(live):
        return torch.empty_like(h)
    rows = h.shape[0]
    img = torch.arange(rows, device=h.device) // (rows // feats.shape[0])
    word = w["emb"][tok.long()].float()
    if t == 0 and zero_word_t0:
        word = torch.zeros_like(word)
    att2 = torch.matmul(h, w["ua_w"].float()) + w["ua_b"]
    e = torch.tanh(att1.float()[img] + att2[:, None, :])
    s = torch.sum(e * w["va"], dim=2)
    s = s - s.max(dim=1, keepdim=True).values
    p = torch.exp(s)
    p = p / p.sum(dim=1, keepdim=True)
    ctx = torch.sum(p[:, :, None] * feats.float()[img], dim=1)
    x = torch.cat([word, ctx], dim=1)
    n_styles = w["wih_t"].shape[0]
    srow = styles.long().clamp(0, n_styles - 1)[img]
    G = w["bih"].shape[1]
    gi = torch.empty((rows, G), device=h.device)
    gh = torch.empty((rows, G), device=h.device)
    for s_id in range(n_styles):
        m = srow == s_id
        gi[m] = torch.matmul(x[m], w["wih_t"][s_id].float()) + w["bih"][s_id]
        gh[m] = torch.matmul(h[m], w["whh_t"][s_id].float()) + w["bhh"][s_id]
    hd = h.shape[1]
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    return (1.0 - z) * n + z * h


def cell_step(feats, att1, h, tok, styles, t: int, w: Dict[str, torch.Tensor],
              zero_word_t0: bool = True, live: Optional[torch.Tensor] = None,
              block_rows: int = 12) -> torch.Tensor:
    """(a) for all rows; the CUDA kernel on the card, the plain version for
    CPU tensors.  ``feats`` [B, R, F] and ``att1`` [B, R, H] are per image in
    the weight dtype, ``styles`` [B] int32 (clamped here); ``h`` has a whole
    number of rows per image.  ``live`` gates the step (see the module
    note); ``block_rows`` is the rows per block (one of ``TILE_ROWS``)."""
    if block_rows not in TILE_ROWS:
        raise ValueError(f"block_rows must be one of {TILE_ROWS}")
    if h.device.type == "cpu":
        return cell_step_plain(feats, att1, h, tok, styles, t, w, zero_word_t0, live)
    dev = _launch_device(h)
    wdt = w["wih_t"].dtype
    if wdt not in _SUFFIX:
        raise ValueError(f"weight dtype {wdt} has no kernel")
    B, R, F = feats.shape
    rows, H = h.shape
    S, In, G = w["wih_t"].shape
    E = w["emb"].shape[1]
    if B == 0 or rows % B or In != E + F or G != 3 * H:
        raise ValueError("inconsistent shapes for cell_step")
    for name, x, dt, shape in (
        ("feats", feats, wdt, (B, R, F)), ("att1", att1, wdt, (B, R, H)),
        ("h", h, torch.float32, (rows, H)), ("tok", tok, torch.int32, (rows,)),
        ("styles", styles, torch.int32, (B,)),
        ("emb", w["emb"], wdt, (w["emb"].shape[0], E)),
        ("ua_w", w["ua_w"], wdt, (H, H)), ("ua_b", w["ua_b"], torch.float32, (H,)),
        ("va", w["va"], torch.float32, (H,)),
        ("wih_t", w["wih_t"], wdt, (S, In, G)), ("whh_t", w["whh_t"], wdt, (S, H, G)),
        ("bih", w["bih"], torch.float32, (S, G)), ("bhh", w["bhh"], torch.float32, (S, G)),
    ):
        _check(x, name, dev, dt, shape)
    gate = _check_live(live, dev, 1)
    h_new = torch.empty_like(h)
    with torch.cuda.device(dev):
        CELL.launch(
            f"cell_step_{_SUFFIX[wdt]}",
            _ptr(feats), _ptr(att1), _ptr(h), _ptr(tok), _ptr(styles), t,
            _ptr(w["emb"]), _ptr(w["ua_w"]), _ptr(w["ua_b"]), _ptr(w["va"]),
            _ptr(w["wih_t"]), _ptr(w["whh_t"]), _ptr(w["bih"]), _ptr(w["bhh"]),
            _ptr(h_new), gate, rows, rows // B, int(zero_word_t0), R, F, E, H, S,
            block_rows, torch.cuda.current_stream(dev).cuda_stream,
        )
    return h_new


# ====================================================================
# (b) vocab product + per-chunk top-3 / logsumexp partials
# ====================================================================
def logits_top3_partial_plain(h_new, fc_w, fc_b, live: Optional[torch.Tensor] = None):
    """h_new [rows, H] -> per (row, 128-column chunk): top-3 values [rows, C, 3]
    f32, their vocab indices [rows, C, 3] int32, the chunk max [rows, C] and
    the sum of exp(logit - max) [rows, C]."""
    rows = h_new.shape[0]
    vp = fc_w.shape[1]
    C = vp // CHUNK
    if not _runs(live):
        dev = h_new.device
        return (torch.empty((rows, C, 3), device=dev),
                torch.empty((rows, C, 3), dtype=torch.int32, device=dev),
                torch.empty((rows, C), device=dev), torch.empty((rows, C), device=dev))
    x = (torch.matmul(h_new, fc_w.float()) + fc_b).reshape(rows * C, CHUNK)
    v, i = top_k_first(x, 3)
    m = x.max(dim=1).values
    s = torch.exp(x - m[:, None]).sum(dim=1)
    base = (torch.arange(C, device=h_new.device) * CHUNK)[None, :, None]
    idx = (i.reshape(rows, C, 3) + base).to(torch.int32)
    return v.reshape(rows, C, 3), idx, m.reshape(rows, C), s.reshape(rows, C)


def _check_logits_args(h_new, fc_w, fc_b) -> Tuple[torch.device, int, int]:
    """Device, rows and chunk count of a vocab-product launch, or raise."""
    dev = _launch_device(h_new)
    rows, H = h_new.shape
    vp = fc_w.shape[1]
    if vp % CHUNK:
        raise ValueError(f"padded vocab {vp} is not a multiple of {CHUNK}")
    if fc_w.dtype not in _SUFFIX:
        raise ValueError(f"fc_w dtype {fc_w.dtype} has no kernel")
    _check(h_new, "h_new", dev, torch.float32, (rows, H))
    _check(fc_w, "fc_w", dev, fc_w.dtype, (H, vp))
    _check(fc_b, "fc_b", dev, torch.float32, (vp,))
    return dev, rows, vp // CHUNK


def logits_top3_partial(h_new, fc_w, fc_b, live: Optional[torch.Tensor] = None):
    """(b); the CUDA kernel on the card, the plain version for CPU tensors."""
    if h_new.device.type == "cpu":
        return logits_top3_partial_plain(h_new, fc_w, fc_b, live)
    dev, rows, C = _check_logits_args(h_new, fc_w, fc_b)
    gate = _check_live(live, dev, 1)
    pv = torch.empty((rows, C, 3), dtype=torch.float32, device=dev)
    pi = torch.empty((rows, C, 3), dtype=torch.int32, device=dev)
    pm = torch.empty((rows, C), dtype=torch.float32, device=dev)
    ps = torch.empty((rows, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        LOGITS.launch(
            f"logits_top3_partial_{_SUFFIX[fc_w.dtype]}",
            _ptr(h_new), _ptr(fc_w), _ptr(fc_b), _ptr(pv), _ptr(pi), _ptr(pm),
            _ptr(ps), gate, rows, h_new.shape[1], fc_w.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return pv, pi, pm, ps


# ====================================================================
# (c) beam selection and bookkeeping (updates the state in place)
# ====================================================================
def beam_select_plain(pv, pi, pm, ps, h_new, state: Dict[str, torch.Tensor],
                      t: int, end_id: int) -> None:
    """One step of beam bookkeeping on ``state`` (see :func:`_init_state`):
    reads ``hist_in``, writes ``hist_out``; updates h, tok, score and the
    best completion in place; sets ``run[t+1]`` when some row's score still
    exceeds its image's best completion.  Gated by ``run[t]``."""
    if not _runs(state["run"][t:]):
        return
    rows, C, _ = pv.shape
    n_img = rows // K
    dev = pv.device
    v3, sel = top_k_first(pv.reshape(rows, 3 * C), 3)
    i3 = torch.gather(pi.reshape(rows, 3 * C), 1, sel)
    M = pm.max(dim=1).values
    logz = M + torch.log(torch.sum(ps * torch.exp(pm - M[:, None]), dim=1))
    cand = state["score"][:, None] + (v3 - logz[:, None])
    gv, gs = top_k_first(cand.reshape(n_img, K * 3), 3)
    new_tok = torch.gather(i3.reshape(n_img, K * 3), 1, gs)
    src = (torch.arange(n_img, device=dev) * K)[:, None] + gs // 3
    src = src.reshape(-1)
    state["h"].copy_(h_new[src])
    hist = state["hist_in"][src]
    hist[:, t + 1] = new_tok.reshape(-1)
    state["hist_out"].copy_(hist)
    completed = (new_tok == end_id) & (gv > NEG_INF / 2)
    cval = torch.where(completed, gv, torch.full_like(gv, NEG_INF))
    cbest, win = top_k_first(cval, 1)
    cbest, win = cbest[:, 0], win[:, 0]
    improve = (cbest > state["best_val"]) & (cbest > NEG_INF / 2)
    win_rows = torch.arange(n_img, device=dev) * K + win
    state["best_seq"][improve] = hist[win_rows[improve]]
    state["best_val"][improve] = cbest[improve]
    state["best_len"][improve] = t + 2
    state["found"] |= completed.any(dim=1).to(torch.int32)
    score = torch.where(completed, torch.full_like(gv, NEG_INF), gv)
    state["score"].copy_(score.reshape(-1))
    state["tok"].copy_(new_tok.reshape(-1))
    improvable = (score - state["best_val"][:, None]) > 0.0
    state["run"][t + 1] = improvable.any().to(torch.int32)


def beam_select(pv, pi, pm, ps, h_new, state: Dict[str, torch.Tensor],
                t: int, end_id: int) -> None:
    """(c); the CUDA kernel on the card, the plain version for CPU tensors."""
    if pv.device.type == "cpu":
        return beam_select_plain(pv, pi, pm, ps, h_new, state, t, end_id)
    dev = _launch_device(pv)
    rows, C, _ = pv.shape
    n_img = rows // K
    H = h_new.shape[1]
    T = state["hist_in"].shape[1]
    if rows != n_img * K or not 0 <= t < T - 1:
        raise ValueError("inconsistent shapes or step for beam_select")
    for name, x, dt, shape in (
        ("pv", pv, torch.float32, (rows, C, 3)), ("pi", pi, torch.int32, (rows, C, 3)),
        ("pm", pm, torch.float32, (rows, C)), ("ps", ps, torch.float32, (rows, C)),
        ("h_new", h_new, torch.float32, (rows, H)),
        ("h", state["h"], torch.float32, (rows, H)),
        ("tok", state["tok"], torch.int32, (rows,)),
        ("score", state["score"], torch.float32, (rows,)),
        ("hist_in", state["hist_in"], torch.int32, (rows, T)),
        ("hist_out", state["hist_out"], torch.int32, (rows, T)),
        ("best_seq", state["best_seq"], torch.int32, (n_img, T)),
        ("best_val", state["best_val"], torch.float32, (n_img,)),
        ("best_len", state["best_len"], torch.int32, (n_img,)),
        ("found", state["found"], torch.int32, (n_img,)),
        ("run", state["run"], torch.int32, (T,)),
    ):
        _check(x, name, dev, dt, shape)
    with torch.cuda.device(dev):
        SELECT.launch(
            "beam_select",
            _ptr(pv), _ptr(pi), _ptr(pm), _ptr(ps), _ptr(h_new), _ptr(state["h"]),
            _ptr(state["tok"]), _ptr(state["score"]), _ptr(state["hist_in"]),
            _ptr(state["hist_out"]), _ptr(state["best_seq"]), _ptr(state["best_val"]),
            _ptr(state["best_len"]), _ptr(state["found"]), _ptr(state["run"][t:]),
            n_img, C, H, T, t, end_id, torch.cuda.current_stream(dev).cuda_stream,
        )


# ====================================================================
# (b1) vocab product + per-chunk maximum and first argmax
# ====================================================================
def logits_top1_partial_plain(h_new, fc_w, fc_b, live: Optional[torch.Tensor] = None):
    """h_new [rows, H] -> per (row, 128-column chunk): the maximum logit
    [rows, C] f32 and its first vocab index [rows, C] int32."""
    rows = h_new.shape[0]
    C = fc_w.shape[1] // CHUNK
    if not _runs(live):
        return (torch.empty((rows, C), device=h_new.device),
                torch.empty((rows, C), dtype=torch.int32, device=h_new.device))
    x = (torch.matmul(h_new, fc_w.float()) + fc_b).reshape(rows * C, CHUNK)
    v, i = top_k_first(x, 1)
    base = (torch.arange(C, device=h_new.device) * CHUNK)[None, :]
    return v.reshape(rows, C), (i.reshape(rows, C) + base).to(torch.int32)


def logits_top1_partial(h_new, fc_w, fc_b, live: Optional[torch.Tensor] = None):
    """(b1); the CUDA kernel on the card, the plain version for CPU tensors."""
    if h_new.device.type == "cpu":
        return logits_top1_partial_plain(h_new, fc_w, fc_b, live)
    dev, rows, C = _check_logits_args(h_new, fc_w, fc_b)
    gate = _check_live(live, dev, 1)
    pv = torch.empty((rows, C), dtype=torch.float32, device=dev)
    pi = torch.empty((rows, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        LOGITS1.launch(
            f"logits_top1_partial_{_SUFFIX[fc_w.dtype]}",
            _ptr(h_new), _ptr(fc_w), _ptr(fc_b), _ptr(pv), _ptr(pi), gate, rows,
            h_new.shape[1], fc_w.shape[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    return pv, pi


# ====================================================================
# (c1) greedy selection and bookkeeping (updates the state in place)
# ====================================================================
def greedy_select_plain(pv, pi, h_new, state: Dict[str, torch.Tensor], t: int,
                        end_id: int) -> None:
    """One greedy step on ``state`` (see :func:`_init_greedy_state`): the
    next token is the first argmax over the chunk partials; writes
    ``out[:, t]``, retires rows on ``</s>``, keeps a retired row's h and
    token, and sets ``run[t+1]`` while some row is not done.  Gated by
    ``run[t]``."""
    if not _runs(state["run"][t:]):
        return
    _, sel = top_k_first(pv, 1)
    nxt = torch.gather(pi, 1, sel)[:, 0]
    was_done = state["done"].bool()
    state["out"][:, t] = torch.where(was_done, torch.zeros_like(nxt), nxt)
    state["h"].copy_(torch.where(was_done[:, None], state["h"], h_new))
    state["tok"].copy_(torch.where(was_done, state["tok"], nxt))
    now_done = was_done | (nxt == end_id)
    state["done"].copy_(now_done.to(torch.int32))
    state["run"][t + 1] = (~now_done).any().to(torch.int32)


def greedy_select(pv, pi, h_new, state: Dict[str, torch.Tensor], t: int,
                  end_id: int) -> None:
    """(c1); the CUDA kernel on the card, the plain version for CPU tensors."""
    if pv.device.type == "cpu":
        return greedy_select_plain(pv, pi, h_new, state, t, end_id)
    dev = _launch_device(pv)
    rows, C = pv.shape
    H = h_new.shape[1]
    max_len = state["out"].shape[1]
    if not 0 <= t < max_len:
        raise ValueError("step out of range for greedy_select")
    for name, x, dt, shape in (
        ("pv", pv, torch.float32, (rows, C)), ("pi", pi, torch.int32, (rows, C)),
        ("h_new", h_new, torch.float32, (rows, H)),
        ("h", state["h"], torch.float32, (rows, H)),
        ("tok", state["tok"], torch.int32, (rows,)),
        ("done", state["done"], torch.int32, (rows,)),
        ("out", state["out"], torch.int32, (rows, max_len)),
        ("run", state["run"], torch.int32, (max_len + 1,)),
    ):
        _check(x, name, dev, dt, shape)
    with torch.cuda.device(dev):
        GREEDY_SELECT.launch(
            "greedy_select",
            _ptr(pv), _ptr(pi), _ptr(h_new), _ptr(state["h"]), _ptr(state["tok"]),
            _ptr(state["done"]), _ptr(state["out"]), _ptr(state["run"][t:]), rows, C, H,
            max_len, t, end_id, torch.cuda.current_stream(dev).cuda_stream,
        )


# ====================================================================
# the decode loops
# ====================================================================
def _init_state(h0: torch.Tensor, max_steps: int) -> Dict[str, torch.Tensor]:
    """Beam state at step 0: beam 0 of each image alive at 0.0, the others
    at -1e9 (so step 1 expands beam 0 only); no completion yet."""
    B, H = h0.shape
    rows, T, dev = B * K, max_steps + 1, h0.device
    score = torch.full((rows,), NEG_INF, device=dev)
    score[0::K] = 0.0
    return {
        "h": h0.float().repeat_interleave(K, dim=0).contiguous(),
        "tok": torch.zeros((rows,), dtype=torch.int32, device=dev),
        "score": score,
        "hist_in": torch.zeros((rows, T), dtype=torch.int32, device=dev),
        "hist_out": torch.zeros((rows, T), dtype=torch.int32, device=dev),
        "best_seq": torch.zeros((B, T), dtype=torch.int32, device=dev),
        "best_val": torch.full((B,), NEG_INF, device=dev),
        "best_len": torch.zeros((B,), dtype=torch.int32, device=dev),
        "found": torch.zeros((B,), dtype=torch.int32, device=dev),
        "run": _new_run(max_steps, dev),
    }


def _init_greedy_state(h0: torch.Tensor, max_len: int) -> Dict[str, torch.Tensor]:
    """Greedy state at step 0: token 0, no row done, every output <pad>."""
    B = h0.shape[0]
    dev = h0.device
    return {
        "h": h0.float().clone().contiguous(),
        "tok": torch.zeros((B,), dtype=torch.int32, device=dev),
        "done": torch.zeros((B,), dtype=torch.int32, device=dev),
        "out": torch.zeros((B, max_len), dtype=torch.int32, device=dev),
        "run": _new_run(max_len, dev),
    }


def _beam_loop(feats, att1, h0, styles, w, max_steps: int, end_id: int,
               cell, logits, select) -> Tuple[BeamResult, torch.Tensor]:
    """Up to ``max_steps`` beam steps through the given (a), (b), (c).
    -> (result, steps actually run as a device scalar)."""
    state = _init_state(h0, max_steps)
    for t in range(max_steps):
        live = state["run"][t:]
        h_new = cell(feats, att1, state["h"], state["tok"], styles, t, w, live=live)
        pv, pi, pm, ps = logits(h_new, w["fc_w"], w["fc_b"], live=live)
        select(pv, pi, pm, ps, h_new, state, t, end_id)
        state["hist_in"], state["hist_out"] = state["hist_out"], state["hist_in"]
    # positions past the winner's length are already 0: every history row
    # holds zeros beyond step t+1 when it is copied into best_seq
    result = BeamResult(state["best_seq"], state["best_val"],
                        state["found"].bool(), state["best_len"])
    return result, state["run"][:max_steps].sum()


def _greedy_loop(feats, att1, h0, styles, w, max_len: int, end_id: int,
                 cell, logits, select) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``max_len`` greedy steps through the given (a), (b1), (c1).
    -> (int32 tokens [B, max_len], steps actually run as a device scalar)."""
    state = _init_greedy_state(h0, max_len)
    for t in range(max_len):
        live = state["run"][t:]
        h_new = cell(feats, att1, state["h"], state["tok"], styles, t, w, live=live)
        pv, pi = logits(h_new, w["fc_w"], w["fc_b"], live=live)
        select(pv, pi, h_new, state, t, end_id)
    return state["out"], state["run"][:max_len].sum()


class _PackedDecoder(torch.nn.Module):
    """Holds the packed decode weights of one decoder (and one theta or an
    S-theta bank) and turns raw region features into the loops' inputs.
    ``last_steps`` is the number of steps the last call ran (a device
    scalar, None before the first call)."""

    def __init__(self, decoder_params: Dict, gru_params: Optional[Dict], f32: bool,
                 device: DeviceLike):
        super().__init__()
        dev = resolve_device(device)
        params = to_device(decoder_params, dev)
        self.multi = gru_params is not None and gru_params["w_ih"].dim() == 3
        cdt = torch.float32 if f32 else torch.bfloat16
        theta = None if gru_params is None else to_device(gru_params, dev)
        w = _pack_weights(params, None if self.multi else theta, cdt)
        if self.multi:
            w = _pack_weight_bank(w, theta, cdt)
        self.params = params
        self.cdt = cdt
        self.device = dev
        self.last_steps: Optional[torch.Tensor] = None
        self._names = tuple(w)
        for name, t in w.items():
            self.register_buffer(name, t)

    def weights(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    def prepare(self, raw_features, style_rows=None):
        """raw features [B, R, NF] (+ style rows) -> the loop's inputs: feats,
        att1 (weight dtype), h0 (f32) and int32 style rows."""
        if self.multi and style_rows is None:
            raise ValueError("gru_params has a leading style axis; pass style_rows [B]")
        raw = torch.as_tensor(raw_features).to(self.device, torch.float32)
        feats, att1, h0 = _prep_features(self.params, raw)
        B = raw.shape[0]
        if style_rows is None:
            styles = torch.zeros((B,), dtype=torch.int32, device=self.device)
        else:
            styles = torch.as_tensor(style_rows).to(self.device, torch.int32).contiguous()
        return (feats.to(self.cdt).contiguous(), att1.to(self.cdt).contiguous(),
                h0, styles)


class BeamDecoder(_PackedDecoder):
    """k=3 beam decoding of batches of raw region features.

    ``forward`` is the served path through the CUDA kernels (the plain
    versions for CPU tensors); ``forward_plain`` runs the plain versions on
    any device, for holding the kernels against them."""

    def __init__(self, decoder_params: Dict, gru_params: Optional[Dict] = None,
                 max_steps: int = 50, end_id: int = 2, f32: bool = False,
                 block_images: int = 4, device: DeviceLike = None):
        if block_images not in TILE_IMAGES:
            raise ValueError(f"block_images must be one of {TILE_IMAGES}")
        super().__init__(decoder_params, gru_params, f32, device)
        self.max_steps, self.end_id, self.block_images = max_steps, end_id, block_images

    def _run(self, raw_features, style_rows, cell, logits, select) -> BeamResult:
        result, self.last_steps = _beam_loop(
            *self.prepare(raw_features, style_rows), self.weights(), self.max_steps,
            self.end_id, cell, logits, select)
        return result

    def forward(self, raw_features, style_rows=None) -> BeamResult:
        cell = functools.partial(cell_step, block_rows=K * self.block_images)
        return self._run(raw_features, style_rows, cell, logits_top3_partial, beam_select)

    def forward_plain(self, raw_features, style_rows=None) -> BeamResult:
        return self._run(raw_features, style_rows, cell_step_plain,
                         logits_top3_partial_plain, beam_select_plain)


class GreedyDecoder(_PackedDecoder):
    """Greedy decoding of batches of raw region features -> int32 tokens
    [B, max_len].  ``forward`` goes through the CUDA kernels (the plain
    versions for CPU tensors); ``forward_plain`` runs the plain versions on
    any device."""

    def __init__(self, decoder_params: Dict, gru_params: Optional[Dict] = None,
                 max_len: int = 20, end_id: int = 2, f32: bool = False,
                 device: DeviceLike = None):
        super().__init__(decoder_params, gru_params, f32, device)
        self.max_len, self.end_id = max_len, end_id

    def _run(self, raw_features, style_rows, cell, logits, select) -> torch.Tensor:
        tokens, self.last_steps = _greedy_loop(
            *self.prepare(raw_features, style_rows), self.weights(), self.max_len,
            self.end_id, cell, logits, select)
        return tokens

    def forward(self, raw_features, style_rows=None) -> torch.Tensor:
        cell = functools.partial(cell_step, zero_word_t0=False, block_rows=GREEDY_BLOCK_ROWS)
        return self._run(raw_features, style_rows, cell, logits_top1_partial, greedy_select)

    def forward_plain(self, raw_features, style_rows=None) -> torch.Tensor:
        cell = functools.partial(cell_step_plain, zero_word_t0=False)
        return self._run(raw_features, style_rows, cell, logits_top1_partial_plain,
                         greedy_select_plain)


def fused_beam_search(
    decoder_params: Dict,
    raw_features,
    gru_params: Optional[Dict] = None,
    max_steps: int = 50,
    end_id: int = 2,
    block_images: int = 4,
    f32: bool = False,
    style_rows=None,
    device: DeviceLike = None,
) -> BeamResult:
    """k=3 beam search through the K1 kernels.  -> BeamResult (tokens
    [B, max_steps+1], scores [B], found [B], lengths [B]).

    ``f32`` keeps every weight in f32 (exact parity with the plain version
    up to the order of sums); the default stores weights and features in
    bf16 and computes in f32.  Mixed-style batches: ``gru_params`` with a
    leading style axis (a bank from ``synthesize_theta_batched``) plus
    ``style_rows`` [B], clamped to [0, S).  ``block_images`` is the number
    of images per block of the cell kernel (1, 2 or 4)."""
    decoder = BeamDecoder(decoder_params, gru_params, max_steps, end_id, f32,
                          block_images, device)
    return decoder(raw_features, style_rows)


def fused_greedy(
    decoder_params: Dict,
    raw_features,
    gru_params: Optional[Dict] = None,
    max_len: int = 20,
    end_id: int = 2,
    f32: bool = False,
    style_rows=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Greedy decode through the K2 kernels.  -> int32 token ids
    [B, max_len]; positions after ``</s>`` are ``<pad>``.

    ``f32`` and mixed-style batches as in :func:`fused_beam_search`: a
    ``gru_params`` bank with a leading style axis needs ``style_rows`` [B],
    clamped to [0, S)."""
    decoder = GreedyDecoder(decoder_params, gru_params, max_len, end_id, f32, device)
    return decoder(raw_features, style_rows)
