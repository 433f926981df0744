"""Fused ResNet bottleneck chains for the H100 — K4 — and their plain version.

Port of ``pack_stage`` and ``fused_stage`` from
``captionax/ops/conv_kernel.py``.  On the TPU one Pallas launch
(``_stage_kernel``, ``_stage_kernel_nodown``) runs a whole chain of stride-1
bottleneck blocks with the activations resident in VMEM.  A Hopper block has
227 KB of shared memory, less than one image's stage-1 activation, so here a
block is three hand-written CUDA kernels (four for block 0 with a
projection) that pass activations through device memory
(``csrc/conv_stage.cu``):

- ``conv1x1_bn``  a 1x1 conv as a GEMM with the folded-BN scale/bias
  epilogue (conv1 with ReLU, the projection without, conv3 with the residual
  added before the ReLU);
- ``conv3x3_bn``  the 3x3 conv with pad 1 as an implicit GEMM (K = 9M),
  zero borders gathered by the kernel.

One C call per chain issues all of its launches.  The bf16 kernels run on
Hopper's ``wgmma`` (bf16 in, f32 accumulators in registers) over 128-row
output tiles whose width :func:`tile_width` picks per launch (64, 128 or
256), fed by a four-stage ring of 16-byte ``cp.async`` copies in the
128-byte swizzled layout that the ``wgmma`` descriptors name; the 3x3
conv's im2col is gathered by the copies, zeros at the halo, and W is read
in its packed [K, N] layout as a transposed operand.  The epilogue runs
from the accumulator registers, each lane writing 16 bytes.  At B=64 the
launches are bound by the traffic from L2 into shared memory, which a
tiled product multiplies (W is re-read once per row tile).  The f32
kernels run in full f32 on the CUDA cores, 64 x 64 tiles.

Each block computes, from x in the compute dtype (bf16, or f32 with
``f32=True``):

    y1  = round(relu(x  @ W1 * s1 + b1))
    y2  = round(relu(conv3x3(y1) @ W2 * s2 + b2))
    out = round(relu(y2 @ W3 * s3 + b3 + identity))

with every product accumulated in f32, the epilogue in f32 from the f32
scale/bias rows, and identity = round(x @ Wd * sd + bd) on block 0 when it
has a projection, else the block's input — the rounding points of the JAX
kernel.  ``default_block_images`` and ``conv2_mode`` are VMEM and Mosaic
choices of the TPU kernel; "bigk" and "taps" compute the same function as
this one, and the ablations "skip" / "noshift" are not ported.

:func:`fused_stage` launches the kernels for CUDA tensors (or raises) and
runs :func:`fused_stage_plain` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from captionax_torch.ops._cuda import KernelOp, call
from captionax_torch.ops.decode_kernel import _SUFFIX, _check, _launch_device, _ptr

CONV1X1 = KernelOp("conv1x1_bn")
CONV3X3 = KernelOp("conv3x3_bn")
KERNELS = (CONV1X1, CONV3X3)
# launches of both kernels by the output width C of the chain that issued
# them (256, 512, 1024, 2048 for the four ResNet stages); reset with the counts
LAUNCHES_BY_WIDTH: Counter = Counter()
SMS = 132              # streaming multiprocessors of an H100 SXM
TILE_ROWS = 128        # output rows of a bf16 block (csrc ``wg::kBM``)
TILE_WIDTHS = (256, 128, 64)  # the bf16 tile widths csrc instantiates


def tile_width(rows: int, n: int) -> int:
    """The width of the bf16 kernel's 128-row output tile for a product of
    ``rows`` x ``n`` outputs (n a multiple of 64).  A launch takes about
    ceil(tiles / SMS) rounds of tiles, each costing about its width plus
    the 128 rows whose A it streams (on the card, chip_smoke.py phase 19
    times every width pair: at B=64, 98 blocks of 256 beat 196 of 128 for
    stage 3's 3x3 conv, and 100 of 128 beat 200 of 64 for stage 4's): the
    width of the fewest rounds x cost, the widest on a tie."""
    row_tiles = -(-rows // TILE_ROWS)

    def cost(bn: int) -> int:
        return -(-row_tiles * (n // bn) // SMS) * (bn + TILE_ROWS)

    return min((bn for bn in TILE_WIDTHS if n % bn == 0), key=cost)


def pack_stage(blocks: List[Dict], dtype: Optional[torch.dtype] = None) -> Dict:
    """A chain of bottleneck block params (the folded-BN layout of
    ``encoder.resnet_init`` / ``from_torch_state_dict``) -> the stacked
    operands of :func:`fused_stage`, as captionax's ``pack_stage`` stacks
    them.  All blocks are stride 1; only block 0 may carry a ``downsample``
    (absent: ``wd``/``sbd`` are None).  ``dtype`` casts the weights (not the
    scale/bias rows) once, so that a caller packing for many calls does not
    cast on each."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    n = len(blocks)
    b0 = blocks[0]

    def sb(p):
        return torch.stack([p["scale"], p["bias"]])

    w1f = b0["conv1"]["kernel"][0, 0]
    if "downsample" in b0:
        wd, sbd = cast(b0["downsample"]["kernel"][0, 0]), sb(b0["downsample"])
    else:
        wd = sbd = None
    if n > 1:
        w1r = torch.stack([b["conv1"]["kernel"][0, 0] for b in blocks[1:]])
        sb1r = torch.stack([sb(b["conv1"]) for b in blocks[1:]])
    else:
        M = w1f.shape[1]
        C = b0["conv3"]["kernel"].shape[3]
        w1r = w1f.new_zeros((1, C, M))
        sb1r = w1f.new_zeros((1, 2, M))
    w2 = torch.stack([b["conv2"]["kernel"].reshape(9, *b["conv2"]["kernel"].shape[2:])
                      for b in blocks])
    return {
        "w1f": cast(w1f).contiguous(), "sb1f": sb(b0["conv1"]), "wd": wd, "sbd": sbd,
        "w1r": cast(w1r), "sb1r": sb1r, "w2": cast(w2),
        "sb2": torch.stack([sb(b["conv2"]) for b in blocks]),
        "w3": cast(torch.stack([b["conv3"]["kernel"][0, 0] for b in blocks])),
        "sb3": torch.stack([sb(b["conv3"]) for b in blocks]),
    }


def _dims(x: torch.Tensor, packed: Dict):
    B, S, S2, Cin = x.shape
    n, _, M, _ = packed["w2"].shape
    C = packed["w3"].shape[2]
    if S != S2:
        raise ValueError(f"fused_stage takes square images, got {tuple(x.shape)}")
    return B, S, Cin, C, M, n


def fused_stage_plain(x: torch.Tensor, packed: Dict, *, f32: bool = False) -> torch.Tensor:
    """x [B, S, S, Cin] -> [B, S, S, C] in the compute dtype; the function of
    the kernels in plain PyTorch (products as f32 matmuls of values in the
    compute dtype, the 3x3 conv as the "bigk" patch matrix)."""
    cdt = torch.float32 if f32 else torch.bfloat16
    B, S, Cin, C, M, n = _dims(x, packed)
    rows = B * S * S

    def mm(a, w):
        return a.float() @ w.to(cdt).float()

    def epi(acc, sb, ident=None, relu=True):
        y = acc * sb[0].float() + sb[1].float()
        if ident is not None:
            y = y + ident.float()
        return (torch.relu(y) if relu else y).to(cdt)

    def block(xin, w1, sb1, bi, ident):
        y1 = epi(mm(xin, w1), sb1)
        yp = F.pad(y1.reshape(B, S, S, M), (0, 0, 1, 1, 1, 1))
        patches = torch.cat([yp[:, dy:dy + S, dx:dx + S, :].reshape(rows, M)
                             for dy in range(3) for dx in range(3)], dim=1)
        y2 = epi(mm(patches, packed["w2"][bi].reshape(9 * M, M)), packed["sb2"][bi])
        return epi(mm(y2, packed["w3"][bi]), packed["sb3"][bi], ident)

    x2d = x.to(cdt).reshape(rows, Cin)
    ident = x2d
    if packed["wd"] is not None:
        ident = epi(mm(x2d, packed["wd"]), packed["sbd"], relu=False)
    cur = block(x2d, packed["w1f"], packed["sb1f"], 0, ident)
    for bi in range(1, n):
        cur = block(cur, packed["w1r"][bi - 1], packed["sb1r"][bi - 1], bi, cur)
    return cur.reshape(B, S, S, C)


def fused_stage(x: torch.Tensor, packed: Dict, *, f32: bool = False) -> torch.Tensor:
    """Apply a packed chain of stride-1 bottleneck blocks to x [B, S, S, Cin]
    -> [B, S, S, C] in the compute dtype (bf16, or f32 with ``f32=True``).

    ``packed`` comes from :func:`pack_stage`; weights not yet in the compute
    dtype are cast here.  CUDA tensors go through K4 (one C call for the
    chain), CPU tensors through :func:`fused_stage_plain`; other devices
    raise."""
    if x.device.type == "cpu":
        return fused_stage_plain(x, packed, f32=f32)
    dev = _launch_device(x)
    cdt = torch.float32 if f32 else torch.bfloat16
    B, S, Cin, C, M, n = _dims(x, packed)
    if B == 0 or Cin % 32 or C % 64 or M % 64:
        raise ValueError(f"fused_stage: widths Cin={Cin} (a multiple of 32), C={C} and "
                         f"M={M} (multiples of 64), B={B} > 0 are what the kernels take")
    has_down = packed["wd"] is not None
    shapes = {"x": (B, S, S, Cin), "w1f": (Cin, M), "sb1f": (2, M),
              "w1r": (max(n - 1, 1), C, M), "sb1r": (max(n - 1, 1), 2, M),
              "w2": (n, 9, M, M), "sb2": (n, 2, M), "w3": (n, M, C), "sb3": (n, 2, C)}
    if has_down:
        shapes.update(wd=(Cin, C), sbd=(2, C))
    ops = {}
    for name, shape in shapes.items():
        dt = torch.float32 if name.startswith("sb") else cdt
        ops[name] = x.to(dt).contiguous() if name == "x" else packed[name].to(dt)
        _check(ops[name], name, dev, dt, shape)
        if ops[name].data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (the kernels load 16 bytes)")
    rows = B * S * S
    out = torch.empty((B, S, S, C), dtype=cdt, device=dev)
    tmp = torch.empty_like(out) if n > 1 else None
    y1 = torch.empty((rows, M), dtype=cdt, device=dev)
    y2 = torch.empty_like(y1)
    idt = torch.empty_like(out) if has_down else None
    counts = (ctypes.c_int * 2)()
    opt = lambda t: 0 if t is None else _ptr(t)  # noqa: E731
    widths = () if f32 else (tile_width(rows, M), tile_width(rows, C))
    with torch.cuda.device(dev):
        call(f"conv_stage_{_SUFFIX[cdt]}",
             _ptr(ops["x"]), _ptr(ops["w1f"]), _ptr(ops["sb1f"]), opt(ops.get("wd")),
             opt(ops.get("sbd")), _ptr(ops["w1r"]), _ptr(ops["sb1r"]), _ptr(ops["w2"]),
             _ptr(ops["sb2"]), _ptr(ops["w3"]), _ptr(ops["sb3"]), _ptr(out), opt(tmp),
             _ptr(y1), _ptr(y2), opt(idt), B, S, Cin, C, M, n, int(has_down),
             ctypes.addressof(counts), torch.cuda.current_stream(dev).cuda_stream, *widths)
    CONV1X1.launches += counts[0]
    CONV3X3.launches += counts[1]
    LAUNCHES_BY_WIDTH[C] += counts[0] + counts[1]
    return out
