"""The fused teacher-forced recurrence of training for the H100 — K3, its
forward and its backward (BPTT) — and their plain versions.

Port of ``fused_teacher_forced_hidden`` from
``captionax/ops/train_kernel.py``.  The encoder MLP, ``att1 = W_a f``, h0
and the embedding lookup stay outside the kernels (ordinary autograd); the
T-step attention-GRU recurrence is one ``torch.autograd.Function`` whose
forward and backward are hand-written CUDA kernels
(``csrc/train_recurrence.cu``):

- :func:`fused_fwd`  one launch, ``train_fwd``: one block per tile of
  ``BLOCK_ROWS`` rows loops over all T steps with h in shared memory
  (replaces ``_fwd_kernel``) -> hs [B, T, H] in f32;
- :func:`fused_bwd`  three launches (replace ``_bwd_kernel``):
  :func:`bwd_recurrence` (``train_bwd_recurrence``) runs the exact BPTT
  in reverse time per row tile, recomputing each step from the saved hs,
  and writes the per-row gradients (feats, att1, h0, embeds) plus, for
  every (step, row), the operands of the weight gradients;
  :func:`wgrad_partial` (``train_wgrad_partial``) sums those over all T*B
  rows in split chunks (X^T dGI, Hprev^T dGH, Hprev^T dATT2 and the column
  sums for the biases); :func:`wgrad_reduce` (``train_wgrad_reduce``) adds
  the chunks, and the per-block partials of d(v_a), in a fixed order.

On the TPU the grid runs in order and every tile adds its weight gradients
into one revisited output block.  Hopper's blocks run in parallel in no
order, and d(w_ih) alone (960 KB in f32) exceeds a block's shared memory,
so the cross-block sum is a second pass over rows written to device
memory; its order is fixed, so the gradients are deterministic.

The compute dtype is the dtype of ``raw_features``.  The kernels compute in
f32 on the CUDA cores and round to the compute dtype where the JAX kernel
keeps a value in it (att2 and the attention temporaries, the context, the
operands of the products, the d_feats / d_att1 accumulators), so the bf16
kernels follow the same rounding points as the plain versions.  hs is f32.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version (``*_plain``) for CPU tensors only.  The plain backward is the reverse loop of ``_bwd_kernel`` written
out, not autograd.  Like captionax's kernel, these ignore
``params["layers"]`` (extra GRU layers): hold them against the scan only at
one layer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from captionax_torch.models import decoder as dec
from captionax_torch.models.layers import embedding, linear
from captionax_torch.ops._cuda import KernelOp
from captionax_torch.ops.decode_kernel import _SUFFIX, _check, _launch_device, _ptr

# rows per block of the recurrence kernels (the one tile csrc instantiates):
# B=1024 gives 256 blocks on the 132 SMs
BLOCK_ROWS = 4
WGRAD_SPLITS = 8        # row chunks of the weight-gradient pass

FWD = KernelOp("train_fwd")
BWD = KernelOp("train_bwd_recurrence")
WGRAD = KernelOp("train_wgrad_partial")
WGRAD_REDUCE = KernelOp("train_wgrad_reduce")
KERNELS = (FWD, BWD, WGRAD, WGRAD_REDUCE)


def _dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 product of the operands' values (``preferred_element_type``)."""
    return torch.matmul(a.float(), b.float())


def _word(embeds: torch.Tensor, t: int) -> torch.Tensor:
    """The word consumed at step t: zeros at t=0, else embeds[:, t-1], f32."""
    if t == 0:
        return torch.zeros_like(embeds[:, 0], dtype=torch.float32)
    return embeds[:, t - 1].float()


def _cell(word, h, feats, att1, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """One attention + GRU step from h (f32), as ``_cell_fwd``; the
    intermediates the backward needs come back too."""
    cdt = feats.dtype
    hd = h.shape[1]
    att2 = _dot32(h.to(cdt), ua_w) + ua_b
    a = torch.tanh(att1 + att2[:, None, :].to(cdt))                 # [rows, R, H]
    s = torch.sum(a * va.to(cdt), dim=2).float()
    s = s - s.max(dim=1, keepdim=True).values
    w = torch.exp(s)
    w = w / w.sum(dim=1, keepdim=True)                              # [rows, R] f32
    ctx = torch.sum(w.to(cdt)[:, :, None] * feats, dim=1).float()
    x = torch.cat([word, ctx], dim=1)
    gi = _dot32(x.to(cdt), wih_t) + bih
    gh = _dot32(h.to(cdt), whh_t) + bhh
    r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
    z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    gh_n = gh[:, 2 * hd:]
    n = torch.tanh(gi[:, 2 * hd:] + r * gh_n)
    return (1.0 - z) * n + z * h, (a, w, x, r, z, n, gh_n)


# ====================================================================
# the plain versions
# ====================================================================
def fused_fwd_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """feats [B, R, F] and att1 [B, R, H] in the compute dtype, h0 [B, H],
    embeds [B, T, E] (unshifted), U_a [H, H], w_ih^T [E+F, 3H], w_hh^T
    [H, 3H] in the compute dtype; biases and v_a [H] -> hs [B, T, H] f32."""
    h = h0.float()
    hs = []
    for t in range(embeds.shape[1]):
        h, _ = _cell(_word(embeds, t), h, feats, att1, ua_w, ua_b, va, wih_t, whh_t,
                     bih, bhh)
        hs.append(h)
    return torch.stack(hs, dim=1)


def bwd_recurrence_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh,
                         hs, g):
    """Pass 1 of the BPTT of :func:`fused_fwd_plain` for the cotangent g
    [B, T, H] of hs: the reverse loop of ``_bwd_kernel``, each step
    recomputed from h_{t-1}.  -> (d_feats, d_att1, d_h0, d_emb, rows, dva_part):
    d_feats and d_att1 accumulated in the compute dtype, d_h0 and d_emb
    (already shifted back one step) in f32, and ``rows``, the operands of
    the weight gradients for row n = t*B + b, in f32: ``x`` [N, E+F] (the
    word and the context), ``dgi`` [N, 3H], ``hp`` [N, H] (h_{t-1}),
    ``dghn`` [N, H] (the n-gate part of dgh) and ``datt2`` [N, H]; d(v_a) as
    one partial [1, H] (the kernel gives one per block of rows)."""
    cdt = feats.dtype
    B, R, F = feats.shape
    T, E = embeds.shape[1], embeds.shape[2]
    H = h0.shape[1]
    dev = feats.device
    va_c = va.to(cdt)
    d_va = torch.zeros((H,), dtype=torch.float32, device=dev)
    d_feats = torch.zeros((B, R, F), dtype=cdt, device=dev)
    d_att1 = torch.zeros((B, R, H), dtype=cdt, device=dev)
    d_emb = torch.zeros((B, T, E), dtype=torch.float32, device=dev)
    dh = torch.zeros((B, H), dtype=torch.float32, device=dev)
    rows = {k: [None] * T for k in ("x", "dgi", "hp", "dghn", "datt2")}
    for t in reversed(range(T)):
        h_prev = h0.float() if t == 0 else hs[:, t - 1].float()
        _, (a, w, x, r, z, n, gh_n) = _cell(_word(embeds, t), h_prev, feats, att1, ua_w,
                                            ua_b, va, wih_t, whh_t, bih, bhh)
        dh_new = g[:, t].float() + dh
        dz = dh_new * (h_prev - n)
        dn = dh_new * (1.0 - z)
        dh_prev = dh_new * z
        dpre_n = dn * (1.0 - n * n)
        dr = dpre_n * gh_n
        dpre_r = dr * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dghn = dpre_n * r
        dgh = torch.cat([dpre_r, dpre_z, dghn], dim=1)
        dx = _dot32(dgi.to(cdt), wih_t.t())
        dh_prev = dh_prev + _dot32(dgh.to(cdt), whh_t.t())
        if t > 0:  # the zero word of step 0 has no embedding to receive it
            d_emb[:, t - 1] = dx[:, :E]
        dctx3 = dx[:, None, E:].to(cdt)
        dw = torch.sum(dctx3 * feats, dim=2).float()
        d_feats = d_feats + w.to(cdt)[:, :, None] * dctx3
        ds = w * (dw - torch.sum(w * dw, dim=1, keepdim=True))
        da = ds.to(cdt)[:, :, None] * va_c
        de_lin = da * (1.0 - a * a)
        d_att1 = d_att1 + de_lin
        datt2 = torch.sum(de_lin, dim=1).float()
        d_va += torch.sum(a.float() * ds[:, :, None], dim=(0, 1))
        dh = dh_prev + _dot32(datt2.to(cdt), ua_w.t())
        for k, v in (("x", x), ("dgi", dgi), ("hp", h_prev), ("dghn", dghn),
                     ("datt2", datt2)):
            rows[k][t] = v
    rows = {k: torch.cat(v, dim=0) for k, v in rows.items()}
    return d_feats, d_att1, dh, d_emb, rows, d_va[None]


def wgrad_plain(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The weight gradients summed over the given rows, in the layout of
    :func:`wgrad_layout` — [x | 1]^T dgi, [hp | 1]^T [dgi_rz | dghn] and
    [hp | 1]^T datt2, flattened and concatenated (f32)."""
    ones = lambda a: torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
    hp1 = ones(rows["hp"])
    H = rows["hp"].shape[1]
    dgh = torch.cat([rows["dgi"][:, :2 * H], rows["dghn"]], dim=1)
    return torch.cat([(ones(rows["x"]).t() @ rows["dgi"]).reshape(-1),
                      (hp1.t() @ dgh).reshape(-1), (hp1.t() @ rows["datt2"]).reshape(-1)])


def _chunks(n: int, splits: int):
    """The row ranges of the weight-gradient pass's chunks."""
    per = -(-n // splits)
    return [(min(n, q * per), min(n, (q + 1) * per)) for q in range(splits)]


def wgrad_partial_plain(rows: Dict[str, torch.Tensor]):
    """Pass 2a: :func:`wgrad_plain` of each of the WGRAD_SPLITS chunks of
    rows -> [WGRAD_SPLITS, total]."""
    return torch.stack([wgrad_plain({k: v[a:b] for k, v in rows.items()})
                        for a, b in _chunks(rows["x"].shape[0], WGRAD_SPLITS)])


def wgrad_reduce_plain(partial: torch.Tensor, dva_part: torch.Tensor):
    """Pass 2b: the chunks' sum and the blocks' d(v_a), each added in order."""
    out, d_va = partial[0].clone(), dva_part[0].clone()
    for x in partial[1:]:
        out += x
    for x in dva_part[1:]:
        d_va += x
    return out, d_va


def _split_wgrads(out: torch.Tensor, In: int, H: int):
    """(d_wih, d_bih, d_whh, d_bhh, d_ua_w, d_ua_b): views of pass 2's output."""
    parts = []
    for name in ("wih", "whh", "ua"):
        off, r, c = wgrad_layout(In, H)[name]
        m = out[off:off + r * c].view(r, c)
        parts += [m[:-1], m[-1]]
    return parts


def wgrad_layout(In: int, H: int) -> Dict[str, Tuple[int, int, int]]:
    """Where each weight gradient sits in the output of the weight-gradient
    pass: name -> (offset, rows, columns).  Each product carries one more
    row, the column sums: the bias gradient beside the weight's."""
    G = 3 * H
    o1 = (In + 1) * G
    o2 = o1 + (H + 1) * G
    return {"wih": (0, In + 1, G), "whh": (o1, H + 1, G), "ua": (o2, H + 1, H),
            "total": (o2 + (H + 1) * H, 0, 0)}


def _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va):
    """The eleven gradients, each in its input's dtype, from the passes'
    outputs."""
    feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh = args
    d_wih, d_bih, d_whh, d_bhh, d_ua_w, d_ua_b = _split_wgrads(out, wih_t.shape[0],
                                                               h0.shape[1])
    return (d_feats.to(feats.dtype), d_att1.to(att1.dtype), d_h0.to(h0.dtype),
            d_emb.to(embeds.dtype), d_ua_w.to(ua_w.dtype), d_ua_b.to(ua_b.dtype),
            d_va.to(va.dtype), d_wih.to(wih_t.dtype), d_whh.to(whh_t.dtype),
            d_bih.to(bih.dtype), d_bhh.to(bhh.dtype))


def fused_bwd_plain(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh,
                    hs, g):
    """The exact BPTT of :func:`fused_fwd_plain`: pass 1
    (:func:`bwd_recurrence_plain`), then pass 2 (:func:`wgrad_partial_plain`,
    :func:`wgrad_reduce_plain`).  -> the gradients of the eleven inputs,
    each in its input's dtype; the weight gradients are summed in f32."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    d_feats, d_att1, d_h0, d_emb, rows, dva_part = bwd_recurrence_plain(*args, hs, g)
    out, d_va = wgrad_reduce_plain(wgrad_partial_plain(rows), dva_part)
    return _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va)


# ====================================================================
# the kernels' wrappers
# ====================================================================
def _operands(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
    """The kernels' operands: feats, att1 and the three weight matrices in
    the compute dtype as given; h0, embeds, the biases and v_a widened to
    f32 (exact), all contiguous."""
    c = lambda x: x.contiguous()
    f = lambda x: x.float().contiguous()
    return (c(feats), c(att1), f(h0), f(embeds), c(ua_w), f(ua_b), f(va), c(wih_t),
            c(whh_t), f(bih), f(bhh))


def _check_operands(ops):
    """Device, compute dtype and sizes (B, T, R, F, E, H) of a launch, or raise."""
    feats = ops[0]
    dev = _launch_device(feats)
    cdt = feats.dtype
    if cdt not in _SUFFIX:
        raise ValueError(f"compute dtype {cdt} has no kernel")
    B, R, F = feats.shape
    T, E = ops[3].shape[1], ops[3].shape[2]
    H = ops[2].shape[1]
    f32 = torch.float32
    for name, x, dt, shape in zip(
        ("feats", "att1", "h0", "embeds", "ua_w", "ua_b", "va", "wih_t", "whh_t",
         "bih", "bhh"), ops,
        (cdt, cdt, f32, f32, cdt, f32, f32, cdt, cdt, f32, f32),
        ((B, R, F), (B, R, H), (B, H), (B, T, E), (H, H), (H,), (H,), (E + F, 3 * H),
         (H, 3 * H), (3 * H,), (3 * H,)),
    ):
        _check(x, name, dev, dt, shape)
    if B == 0 or T == 0:
        raise ValueError("empty batch or sequence")
    return dev, cdt, (B, T, R, F, E, H)


def fused_fwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh) -> torch.Tensor:
    """K3's forward: ``train_fwd`` on the card, the plain version for CPU
    tensors.  -> hs [B, T, H] f32."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    if feats.device.type == "cpu":
        return fused_fwd_plain(*args)
    ops = _operands(*args)
    dev, cdt, (B, T, R, F, E, H) = _check_operands(ops)
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        FWD.launch(f"train_fwd_{_SUFFIX[cdt]}", *(_ptr(x) for x in ops), _ptr(hs),
                   B, T, R, F, E, H, BLOCK_ROWS, torch.cuda.current_stream(dev).cuda_stream)
    return hs


def bwd_recurrence(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh, hs, g):
    """K3's backward, pass 1: ``train_bwd_recurrence`` on the card, the plain
    version for CPU tensors.  -> (d_feats, d_att1, d_h0, d_emb, rows,
    dva_part) as :func:`bwd_recurrence_plain` gives them, with one d(v_a)
    partial per block of ``BLOCK_ROWS`` rows."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    if feats.device.type == "cpu":
        return bwd_recurrence_plain(*args, hs, g)
    ops = _operands(*args)
    dev, cdt, (B, T, R, F, E, H) = _check_operands(ops)
    hs, g = hs.contiguous(), g.float().contiguous()
    _check(hs, "hs", dev, torch.float32, (B, T, H))
    _check(g, "g", dev, torch.float32, (B, T, H))
    In, N = E + F, T * B
    f32 = dict(dtype=torch.float32, device=dev)
    d_feats = torch.empty((B, R, F), dtype=cdt, device=dev)
    d_att1 = torch.empty((B, R, H), dtype=cdt, device=dev)
    d_h0 = torch.empty((B, H), **f32)
    d_emb = torch.empty((B, T, E), **f32)
    rows = {"x": torch.empty((N, In), **f32), "dgi": torch.empty((N, 3 * H), **f32),
            "hp": torch.empty((N, H), **f32), "dghn": torch.empty((N, H), **f32),
            "datt2": torch.empty((N, H), **f32)}
    dva_part = torch.empty((-(-B // BLOCK_ROWS), H), **f32)
    with torch.cuda.device(dev):
        BWD.launch(f"train_bwd_recurrence_{_SUFFIX[cdt]}", *(_ptr(x) for x in ops),
                   _ptr(hs), _ptr(g), _ptr(d_feats), _ptr(d_att1), _ptr(d_h0), _ptr(d_emb),
                   *(_ptr(rows[k]) for k in ("x", "dgi", "hp", "dghn", "datt2")),
                   _ptr(dva_part), B, T, R, F, E, H, BLOCK_ROWS,
                   torch.cuda.current_stream(dev).cuda_stream)
    return d_feats, d_att1, d_h0, d_emb, rows, dva_part


def wgrad_partial(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K3's backward, pass 2a: ``train_wgrad_partial`` on the card, the plain
    version for CPU tensors.  -> [WGRAD_SPLITS, total] partial weight
    gradients, one per chunk of rows."""
    x = rows["x"]
    if x.device.type == "cpu":
        return wgrad_partial_plain(rows)
    dev = _launch_device(x)
    N, In = x.shape
    H = rows["hp"].shape[1]
    for k, w in (("x", In), ("dgi", 3 * H), ("hp", H), ("dghn", H), ("datt2", H)):
        _check(rows[k], k, dev, torch.float32, (N, w))
    if N == 0:
        raise ValueError("no rows")
    partial = torch.empty((WGRAD_SPLITS, wgrad_layout(In, H)["total"][0]), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        WGRAD.launch("train_wgrad_partial",
                     *(_ptr(rows[k]) for k in ("x", "dgi", "hp", "dghn", "datt2")),
                     _ptr(partial), N, In, H, WGRAD_SPLITS,
                     torch.cuda.current_stream(dev).cuda_stream)
    return partial


def wgrad_reduce(partial: torch.Tensor, dva_part: torch.Tensor):
    """K3's backward, pass 2b: ``train_wgrad_reduce`` on the card, the plain
    version for CPU tensors.  -> (the weight gradients [total], d(v_a) [H])."""
    if partial.device.type == "cpu":
        return wgrad_reduce_plain(partial, dva_part)
    dev = _launch_device(partial)
    splits, total = partial.shape
    n_blocks, H = dva_part.shape
    _check(partial, "partial", dev, torch.float32, (splits, total))
    _check(dva_part, "dva_part", dev, torch.float32, (n_blocks, H))
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    d_va = torch.empty((H,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        WGRAD_REDUCE.launch("train_wgrad_reduce", _ptr(partial), _ptr(out), total, splits,
                            _ptr(dva_part), _ptr(d_va), n_blocks, H,
                            torch.cuda.current_stream(dev).cuda_stream)
    return out, d_va


def fused_bwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh, hs, g):
    """K3's backward: :func:`bwd_recurrence`, :func:`wgrad_partial`,
    :func:`wgrad_reduce` (three launches on the card, the plain versions
    for CPU tensors).  -> the gradients of the eleven inputs of
    :func:`fused_fwd`, each in its input's dtype."""
    args = (feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
    d_feats, d_att1, d_h0, d_emb, rows, dva_part = bwd_recurrence(*args, hs, g)
    out, d_va = wgrad_reduce(wgrad_partial(rows), dva_part)
    return _gradients(args, d_feats, d_att1, d_h0, d_emb, out, d_va)


class FusedRecurrence(torch.autograd.Function):
    """hs = the T-step recurrence of (feats, att1, h0, embeds, U_a w, U_a b,
    v_a, w_ih^T, w_hh^T, b_ih, b_hh); forward :func:`fused_fwd`, backward
    :func:`fused_bwd` from the saved hs."""

    @staticmethod
    def forward(ctx, feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh):
        hs = fused_fwd(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t, bih, bhh)
        ctx.save_for_backward(feats, att1, h0, embeds, ua_w, ua_b, va, wih_t, whh_t,
                              bih, bhh, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        return fused_bwd(*ctx.saved_tensors, g)


def core_inputs(params: Dict, raw_features: torch.Tensor, captions: torch.Tensor,
                gru_params: Optional[Dict] = None) -> Tuple[torch.Tensor, ...]:
    """The eleven inputs of :class:`FusedRecurrence`, computed outside the
    kernels with ordinary autograd: the encoded features, att1 = W_a f and
    U_a, w_ih^T, w_hh^T in the compute dtype (``raw_features.dtype``), h0,
    the embeddings of the captions, U_a's bias, v_a and the GRU biases."""
    features = dec.encode_features(params, raw_features)
    h0 = dec.init_hidden(params, features)
    att = params["attention"]
    att1 = linear(att["W_a"], features)
    embeds = embedding(params["embed"], captions.long())
    cell = params["gru"] if gru_params is None else gru_params
    cdt = raw_features.dtype
    return (features.to(cdt), att1.to(cdt), h0, embeds, att["U_a"]["w"].to(cdt),
            att["U_a"]["b"], att["v_a"]["w"][:, 0], cell["w_ih"].t().to(cdt),
            cell["w_hh"].t().to(cdt), cell["b_ih"], cell["b_hh"])


def fused_teacher_forced_hidden(params: Dict, raw_features: torch.Tensor,
                                captions: torch.Tensor,
                                gru_params: Optional[Dict] = None) -> Tuple[torch.Tensor, None]:
    """Drop-in for ``teacher_forced_hidden(...)[0]`` under pure teacher
    forcing, with the recurrence on K3.  Differentiable in every decoder
    and theta tensor; the attention weights are not produced (the loss never
    reads them).  d(v_a bias) is exactly 0 (softmax shift invariance).  The
    compute dtype is ``raw_features.dtype``; hs is f32.  Runs where the
    tensors are: the kernels on the card, their plain versions on the CPU."""
    return FusedRecurrence.apply(*core_inputs(params, raw_features, captions, gru_params)), None
