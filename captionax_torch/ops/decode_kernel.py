"""The fused decode kernels for the H100 — K1 (k=3 beam) and K2 (greedy) —
and their plain versions.

Port of ``fused_beam_search`` and ``fused_greedy`` from
``captionax/ops/decode_kernel.py``.  On the TPU one Pallas launch
(``_beam_kernel``, ``_greedy_kernel``) runs a whole decode with the weights
resident in VMEM; here a host loop issues three hand-written CUDA kernels
per step (``csrc/beam_decode.cu``, ``csrc/greedy_decode.cu``):

- :func:`cell_step`            (a) embed, attention, GRU on the theta bank,
  shared by both decodes (3 rows per image and a zero word at t=0 for the
  beam, 1 row per image and the embedding of token 0 for greedy); with
  bf16 weights two launches, an attention phase per image and a gate phase
  on the tensor cores over (row tile, group of hidden units)
  (:func:`gate_tile`), x and h split into three exact bf16 terms, the
  theta packed once per decoder (:func:`pack_gate_theta`, :func:`pack_ua`)
  and a bank taken once per style present in a tile;
- :func:`logits_top3_partial`  (b) vocab product + per-chunk top-3 and
  logsumexp partials, never the whole row of logits; with bf16 weights
  the product runs on the tensor cores, h_new split into three exact bf16
  terms, so it is still the reference's f32 product (the f32 weights'
  instance stays on the CUDA cores); :func:`vocab_items_per_block` spreads
  its 128-row tiles and 128-column chunks over the card's SMs;
- :func:`beam_select`          (c) merge the partials, top-3 of each
  image's 9 candidates, reorder by parent, retire completions; a warp per
  beam row (:func:`select_images_per_block`), its loads in one round of
  16-byte vectors (:func:`row_split`), the merges on warp reductions;
- :func:`logits_top1_partial`  (b1) vocab product + per-chunk maximum and
  first argmax;
- :func:`greedy_select`        (c1) merge the partials into each row's
  first argmax, emit, retire rows on ``</s>``; a warp a row, one round of
  16-byte loads and one warp reduction.

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
import torch.nn.functional as tnf

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.decode.search import NEG_INF, BeamResult, top_k_first
from captionax_torch.interop import to_device
from captionax_torch.models import decoder as dec
from captionax_torch.models.layers import linear
from captionax_torch.ops._cuda import KernelOp

K = 3            # beam width the kernels are written for
CHUNK = 128      # vocab columns per partial of (b) and (b1)
TILE_ROWS = (3, 6, 12)   # rows per block of (a) (bf16: its attention phase) that the library builds
TILE_IMAGES = (1, 2, 4)  # beam images per block of (a): 3, 6 or 12 rows
# the beam decoders' default images per block of (a), by weight dtype: the
# fastest tile at B=1024 on the H100 (PERF.md)
BEAM_BLOCK_IMAGES = {torch.bfloat16: 2, torch.float32: 4}
GREEDY_BLOCK_ROWS = 3    # rows per block of (a) for greedy: the fastest tile (PERF.md)
GATE_UNITS = 8           # hidden units of a group of the packed theta (r, z, n side by side)
# (rows, column groups) a block of the bf16 gate phase can take, largest first
GATE_TILES = ((48, 16), (48, 8), (32, 8), (32, 4), (16, 4), (16, 2), (16, 1))
CELL_MAX_H = 256         # the widest h of the bf16 cell (a lane keeps 8 depths of an att1 row)
CELL_MAX_STYLES = 32     # the bf16 cell marks the styles present in a tile in one 32-bit word
VOCAB_ROWS = 128         # rows per block of the bf16 (b) and (b1): two warpgroups
VOCAB_MAX_H = 256        # the widest h whose three bf16 terms fit in shared memory
SELECT_IMAGES = (4, 2, 1)  # images a block of (c) (three warps each), largest first
GREEDY_SELECT_WARPS = (16, 8, 4, 2, 1)  # warps a block of (c1), largest first
# programmatic dependent launch of (c1), which (b1) lets start early: it
# shortened a greedy step by more than the spread between runs on the H100
# (PERF.md); (c) launches plainly, where it did not
GREEDY_SELECT_PDL = True

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
    if t.device == dev and t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return
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


def vocab_items_per_block(rows: int, n_chunks: int, sms: int) -> int:
    """Items (128-row tile, 128-column chunk) per block of the bf16 (b) and
    (b1): the fewest that put all ``ceil(rows / 128) * n_chunks`` items in
    one wave of ``sms`` blocks.  The kernel runs one block an SM (its shared
    memory holds the row tile's three terms of h, 160 KB at H=200) and walks
    its items row-tile-major, so a block splits each row tile's h once and
    reuses it for all its chunks of that tile."""
    items = -(-rows // VOCAB_ROWS) * n_chunks
    return max(1, -(-items // sms))


def select_images_per_block(n_img: int, sms: int) -> int:
    """Images a block of (c), which runs a warp per beam row: the most of
    SELECT_IMAGES whose grid still has a block for every one of ``sms``
    SMs, else one (the service's 64 images: 64 blocks of 96 threads)."""
    for images in SELECT_IMAGES:
        if -(-n_img // images) >= sms:
            return images
    return 1


def greedy_select_warps(rows: int, sms: int) -> int:
    """Warps a block of (c1), a warp a row: the most of
    GREEDY_SELECT_WARPS whose grid still has a block for every four of
    ``sms`` SMs, else one.  Fewer, larger blocks launch faster, but a
    block's rows then share one SM: on the H100 16 warps a block beat 4 at
    1024 rows and 1 to 8 tied at 64 rows, where 16 was slower (PERF.md)."""
    for warps in GREEDY_SELECT_WARPS:
        if 4 * -(-rows // warps) >= sms:
            return warps
    return 1


def row_split(offset: int, n: int) -> Tuple[int, int, int]:
    """How the select kernels load a row of ``n`` 4-byte partials that starts
    at element ``offset`` of a 16-byte-aligned array: (head, body, tail) =
    the scalars before the first 16-byte boundary, the 16-byte vectors, the
    scalars after them (decode_common.cuh, ``row_split``)."""
    head = min(n, -offset % 4)
    body = (n - head) // 4
    return head, body, n - head - 4 * body


def gate_blocks(rows: int, H: int, tile: Tuple[int, int]) -> int:
    """Blocks of the bf16 cell's gate phase at ``tile`` = (rows, groups of
    GATE_UNITS hidden units) a block."""
    mb, gb = tile
    groups = -(-H // GATE_UNITS)
    return -(-rows // mb) * -(-groups // gb)


@functools.lru_cache(maxsize=256)
def gate_tile(rows: int, H: int, sms: int) -> Tuple[int, int]:
    """The tile (rows, groups of GATE_UNITS hidden units) of a block of the
    bf16 cell's gate phase: the first of GATE_TILES (largest first) whose
    grid fills at least 95% of one wave of ``sms`` blocks, so that the
    products fill the card; the finest when none does (then every block
    runs in one wave).  A block holds its rows' split [x | h] in shared
    memory (one block an SM for 32 and 48 rows); its 8 warps take (group,
    part of the depths), 8 / groups parts a group, or at 16 groups a pair of
    groups each, which reads each fragment of [x | h] once for both.  A
    larger tile reads the packed theta fewer times (once per row tile) and
    [x | h] fewer times (once per block of groups).  95% and not 100%: at
    1024 rows (32, 8) makes 128 blocks and ran faster than (32, 4) with 224
    on the H100, and at 3072 rows (48, 16) with 128 faster than (48, 8) with
    256 (PERF.md)."""
    for tile in GATE_TILES:
        if gate_blocks(rows, H, tile) * 20 >= sms * 19:
            return tile
    return GATE_TILES[-1]


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _vocab_args(h_new, fc_w, dev: torch.device, rows: int, C: int) -> Tuple[int, ...]:
    """The bf16 (b)/(b1) entries' extra argument: items per block; none for
    the f32 entries.  Raises on an h the bf16 kernels do not take."""
    if fc_w.dtype != torch.bfloat16:
        return ()
    if h_new.shape[1] > VOCAB_MAX_H:
        raise ValueError(f"h width {h_new.shape[1]} > {VOCAB_MAX_H}: no bf16 vocab kernel")
    return (vocab_items_per_block(rows, C, _sms(dev)),)


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
def _fragments(w: torch.Tensor) -> torch.Tensor:
    """[..., K, N] (N a multiple of 8) -> mma.sync B fragments [..., KT, N/8,
    32, 4], K padded with zeros to KT * 16: lane l (g = l // 4, q = l % 4)
    of k16 tile kt and n8 tile c holds depths 16 kt + (2q, 2q+1, 2q+8, 2q+9)
    of column 8c + g, the two words of its fragment."""
    *lead, K, N = w.shape
    kt = -(-K // 16)
    w = tnf.pad(w, (0, 0, 0, kt * 16 - K)).reshape(*lead, kt, 16, N // 8, 8).transpose(-3, -2)
    lane = torch.arange(32, device=w.device)
    q, g = lane % 4, lane // 4
    k = torch.stack([2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9], dim=1)
    return w[..., k, g[:, None]]


def pack_gate_theta(wih_t: torch.Tensor, whh_t: torch.Tensor) -> torch.Tensor:
    """The theta bank ``wih_t`` [S, In, 3H], ``whh_t`` [S, H, 3H] in the bf16
    gate phase's layout [S, U, KT, 3, 32, 4] (U = ceil(H / 8) groups of
    hidden units, KT = ceil(In / 16) + ceil(H / 16) k16 tiles: x's, then
    h's): per (style, group u, k16 tile, gate r/z/n) the mma.sync fragments
    of columns gate * H + 8u .. + 7 (:func:`_fragments`), so that a block's
    accumulators hold the r, z and n of the same hidden units.  Units past
    H and depths past In or H are zero."""
    def part(w):
        S, K, G = w.shape
        H = G // 3
        U = -(-H // GATE_UNITS)
        w = tnf.pad(w.reshape(S, K, 3, H), (0, U * GATE_UNITS - H)).permute(0, 2, 1, 3)
        return _fragments(w)  # [S, 3, KT, U, 32, 4]

    pk = torch.cat([part(wih_t), part(whh_t)], dim=2)
    return pk.permute(0, 3, 2, 1, 4, 5).contiguous()


def pack_ua(ua_w: torch.Tensor) -> torch.Tensor:
    """U_a [H, H] as mma.sync B fragments [U, KTh, 32, 4] (column groups of
    8, k16 tiles of h; zeros past H)."""
    H = ua_w.shape[1]
    U = -(-H // GATE_UNITS)
    w = tnf.pad(ua_w, (0, U * GATE_UNITS - H))
    return _fragments(w).permute(1, 0, 2, 3).contiguous()


def _pack_weights(decoder_params: Dict, gru_params: Optional[Dict],
                  weight_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Decoder params -> kernel operands, V padded to a multiple of 128 with
    a -1e9 bias.  The theta is stored as a bank of one: ``wih_t`` [1, In, 3H],
    ``whh_t`` [1, H, 3H], biases [1, 3H] in f32.  bf16 weights also get
    their copies in the bf16 cell's layout, ``ua_pk`` and ``gates_pk``."""
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
    w = {
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
    if weight_dtype == torch.bfloat16:
        w["ua_pk"] = pack_ua(w["ua_w"])
        w["gates_pk"] = pack_gate_theta(w["wih_t"], w["whh_t"])
    return w


def _pack_weight_bank(weights: Dict, thetas: Dict,
                      weight_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Replace the theta of a ``_pack_weights`` dict by a bank of S thetas
    (leading style axis): ``wih_t`` [S, In, 3H], ``whh_t`` [S, H, 3H],
    biases [S, 3H].  The kernel indexes the bank by each image's style."""
    weights["wih_t"] = thetas["w_ih"].transpose(1, 2).to(weight_dtype).contiguous()
    weights["whh_t"] = thetas["w_hh"].transpose(1, 2).to(weight_dtype).contiguous()
    weights["bih"] = thetas["b_ih"].float().contiguous()
    weights["bhh"] = thetas["b_hh"].float().contiguous()
    if weight_dtype == torch.bfloat16:
        weights["gates_pk"] = pack_gate_theta(weights["wih_t"], weights["whh_t"])
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
    """(a) for all rows; the CUDA kernels on the card, the plain version for
    CPU tensors.  ``feats`` [B, R, F] and ``att1`` [B, R, H] are per image in
    the weight dtype, ``styles`` [B] int32 (clamped here); ``h`` has a whole
    number of rows per image.  ``live`` gates the step (see the module
    note); ``block_rows`` (one of ``TILE_ROWS``) is the rows per block of
    the f32 kernel and of the bf16 cell's attention phase, whose gate phase
    takes its tile from :func:`gate_tile`."""
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
    checks = [
        ("feats", feats, wdt, (B, R, F)), ("att1", att1, wdt, (B, R, H)),
        ("h", h, torch.float32, (rows, H)), ("tok", tok, torch.int32, (rows,)),
        ("styles", styles, torch.int32, (B,)),
        ("emb", w["emb"], wdt, (w["emb"].shape[0], E)),
        ("ua_b", w["ua_b"], torch.float32, (H,)), ("va", w["va"], torch.float32, (H,)),
        ("bih", w["bih"], torch.float32, (S, G)), ("bhh", w["bhh"], torch.float32, (S, G)),
    ]
    if wdt == torch.float32:
        checks += [("ua_w", w["ua_w"], wdt, (H, H)), ("wih_t", w["wih_t"], wdt, (S, In, G)),
                   ("whh_t", w["whh_t"], wdt, (S, H, G))]
    else:
        if H > CELL_MAX_H or S > CELL_MAX_STYLES:
            raise ValueError(f"h width {H} > {CELL_MAX_H} or {S} > {CELL_MAX_STYLES} styles: "
                             "no bf16 cell kernel")
        U, KTh = -(-H // GATE_UNITS), -(-H // 16)
        checks += [("ua_pk", w["ua_pk"], wdt, (U, KTh, 32, 4)),
                   ("gates_pk", w["gates_pk"], wdt, (S, U, -(-In // 16) + KTh, 3, 32, 4))]
    for name, x, dt, shape in checks:
        _check(x, name, dev, dt, shape)
    gate = _check_live(live, dev, 1)
    h_new = torch.empty_like(h)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if wdt == torch.float32:
            CELL.launch(
                "cell_step_f32",
                _ptr(feats), _ptr(att1), _ptr(h), _ptr(tok), _ptr(styles), t,
                _ptr(w["emb"]), _ptr(w["ua_w"]), _ptr(w["ua_b"]), _ptr(w["va"]),
                _ptr(w["wih_t"]), _ptr(w["whh_t"]), _ptr(w["bih"]), _ptr(w["bhh"]),
                _ptr(h_new), gate, rows, rows // B, int(zero_word_t0), R, F, E, H, S,
                block_rows, stream,
            )
        else:
            mb, gb = gate_tile(rows, H, _sms(dev))
            # [x | h] split into three bf16 terms, rows up to the gate grid's last
            apk = torch.empty((-(-rows // mb) * mb, 3, (-(-In // 16) + KTh) * 16),
                              dtype=torch.bfloat16, device=dev)
            CELL.launch(
                "cell_step_bf16",
                _ptr(feats), _ptr(att1), _ptr(h), _ptr(tok), _ptr(styles), t,
                _ptr(w["emb"]), _ptr(w["ua_pk"]), _ptr(w["ua_b"]), _ptr(w["va"]),
                _ptr(w["gates_pk"]), _ptr(w["bih"]), _ptr(w["bhh"]), _ptr(apk), _ptr(h_new),
                gate, rows, rows // B, int(zero_word_t0), R, F, E, H, S, block_rows, mb, gb, 3,
                stream,
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
            *_vocab_args(h_new, fc_w, dev, rows, C), torch.cuda.current_stream(dev).cuda_stream,
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
            n_img, C, H, T, t, end_id, select_images_per_block(n_img, _sms(dev)),
            torch.cuda.current_stream(dev).cuda_stream,
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
            h_new.shape[1], fc_w.shape[1], *_vocab_args(h_new, fc_w, dev, rows, C),
            torch.cuda.current_stream(dev).cuda_stream,
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
            max_len, t, end_id, greedy_select_warps(rows, _sms(dev)), int(GREEDY_SELECT_PDL),
            torch.cuda.current_stream(dev).cuda_stream,
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
                 block_images: Optional[int] = None, device: DeviceLike = None):
        if block_images is not None and block_images not in TILE_IMAGES:
            raise ValueError(f"block_images must be one of {TILE_IMAGES}")
        super().__init__(decoder_params, gru_params, f32, device)
        if block_images is None:
            block_images = BEAM_BLOCK_IMAGES[self.cdt]
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
    block_images: Optional[int] = None,
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
    of images per block of the cell kernel (1, 2 or 4; bf16: of its
    attention phase); None takes the fastest for the weight dtype
    (``BEAM_BLOCK_IMAGES``)."""
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
