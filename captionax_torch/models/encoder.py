"""The ResNet image encoder in PyTorch, NHWC with folded BatchNorm.

Port of ``resnet_init``, ``resnet_stem``, ``resnet_apply``,
``encoder_cnn``, ``adaptive_avg_pool``, ``encoder_pooled`` and
``from_torch_state_dict`` from ``captionax/models/encoder.py``.  Parameters
keep the JAX package's layout: conv kernels HWIO, and each BatchNorm folded
into a per-channel ``scale`` and ``bias``.

Where the convolutions run.  The stem and the stride-2 first block of
stages 2-4 run on :func:`_conv` (``F.conv2d`` on channels-last tensors, the
convolutions captionax leaves to XLA).  Every chain of stride-1 bottleneck
blocks — all of stage 1, whose block 0 carries the 1x1 projection, and
blocks 1.. of stages 2-4 — runs on K4 (:func:`ops.conv_kernel.fused_stage`,
the hand-written CUDA kernels on the card; the plain version on the CPU).

bf16 rounding.  captionax's ``resnet_apply`` rounds each conv to bf16 and
applies scale and bias in bf16; K4, like captionax's own ``fused_stage``,
applies them in f32 and rounds once.  In bf16 the port therefore matches
the JAX composition stem -> XLA first blocks -> ``fused_stage`` closely and
captionax's ``resnet_apply`` to bf16 tolerance; in f32 the two agree to the
order of sums.  :func:`encoder_lstm_apply` (the LSTM captioners' global
encoder) runs the same trunk, then a linear layer and BatchNorm1d.

The int8 encoder (:func:`resnet_quantize`, :func:`resnet_calibrate`,
:func:`resnet_apply_int8`, :func:`encoder_cnn_int8`) keeps captionax's
arithmetic: the BN scale folded into each kernel in f32, weights quantized
per output channel (``max|w| / 127``, round half to even, clip +-127),
activations from a static calibrated scale (or the dynamic per-tensor max),
each conv an exact int8 x int8 -> int32 sum, dequantized in f32 and cast
once to the compute dtype; the stem stays unquantized.  captionax computes
these convs in XLA, outside any Pallas kernel, so the port's int8 products
are library calls (:func:`int8_matmul`: ``torch._int_mm`` on the card; an
f64 product, exact for these sums, on the CPU), the 3x3 convs after an NHWC
im2col.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.interop import to_device
from captionax_torch.ops.conv_kernel import fused_stage, fused_stage_plain, pack_stage

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_WIDTH = (64, 128, 256, 512)
EXPANSION = 4
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _conv_bn_init(generator: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                  device: torch.device) -> Dict:
    """He-normal fan_out kernel (torchvision's conv init), identity BN."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    kernel = torch.randn((kh, kw, cin, cout), generator=generator) * std
    return {"kernel": kernel.to(device), "scale": torch.ones(cout, device=device),
            "bias": torch.zeros(cout, device=device)}


def resnet_init(generator: torch.Generator, depth: int = 152,
                device: DeviceLike = None) -> Dict:
    """Random-init ResNet params (bottleneck blocks, folded-BN layout), the
    structure of captionax's ``resnet_init``: every conv3 scale is zero
    (torchvision's ``zero_init_residual``), so each block starts as the
    identity (or the projection).  Drawn on the host from ``generator``."""
    dev = resolve_device(device)
    params: Dict = {"stem": _conv_bn_init(generator, 7, 7, 3, 64, dev)}
    cin = 64
    stages: List = []
    for n_blocks, width in zip(BLOCKS[depth], STAGE_WIDTH):
        cout = width * EXPANSION
        blocks = []
        for b in range(n_blocks):
            block = {
                "conv1": _conv_bn_init(generator, 1, 1, cin, width, dev),
                "conv2": _conv_bn_init(generator, 3, 3, width, width, dev),
                "conv3": _conv_bn_init(generator, 1, 1, width, cout, dev),
            }
            block["conv3"]["scale"] = torch.zeros_like(block["conv3"]["scale"])
            if b == 0:
                block["downsample"] = _conv_bn_init(generator, 1, 1, cin, cout, dev)
            blocks.append(block)
            cin = cout
        stages.append(blocks)
    params["stages"] = stages
    return params


def _conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """NHWC x, HWIO kernel -> NHWC, through ``F.conv2d`` on channels-last
    memory, padding ``pad`` on each side (torch's symmetric padding)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, p: Dict, stride: int = 1, dtype=torch.bfloat16) -> torch.Tensor:
    """conv (pad kh//2 per side) * scale + bias, all in ``dtype``."""
    kh = p["kernel"].shape[0]
    y = _conv2d(x.to(dtype), p["kernel"].to(dtype), stride, kh // 2)
    return y * p["scale"].to(dtype) + p["bias"].to(dtype)


def resnet_stem(p: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """7x7/2 conv (pad 3) + scale/bias + ReLU, then a 3x3/2 max-pool with pad
    1 and -inf padding: [B, H, W, 3] -> [B, H/4, W/4, 64] in the compute dtype."""
    y = _conv2d(images.to(compute_dtype), p["kernel"].to(compute_dtype), 2, 3)
    x = torch.relu(y * p["scale"].to(compute_dtype) + p["bias"].to(compute_dtype))
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _first_block(x: torch.Tensor, block: Dict, dtype) -> torch.Tensor:
    """The stride-2 first block of stages 2-4 on :func:`_conv`, as
    captionax's ``resnet_apply`` computes it."""
    y = torch.relu(_conv(x, block["conv1"], 1, dtype))
    y = torch.relu(_conv(y, block["conv2"], 2, dtype))
    y = _conv(y, block["conv3"], 1, dtype)
    identity = _conv(x, block["downsample"], 2, dtype) if "downsample" in block else x
    return torch.relu(y + identity)


def pack_chains(params: Dict, dtype=None) -> List[Dict]:
    """Per stage, the K4 operands (:func:`pack_stage`) of its chain of
    stride-1 blocks: all blocks of stage 1, blocks 1.. of stages 2-4."""
    return [pack_stage(blocks if s == 0 else blocks[1:], dtype)
            for s, blocks in enumerate(params["stages"])]


def _trunk(params: Dict, chains: List[Dict], images: torch.Tensor, dtype,
           stage: Callable) -> torch.Tensor:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, got {dtype}")
    x = resnet_stem(params["stem"], images, dtype)
    for s, blocks in enumerate(params["stages"]):
        if s > 0:
            x = _first_block(x, blocks[0], dtype)
        x = stage(x, chains[s], f32=dtype == torch.float32)
    return x.float()


def resnet_apply(params: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """images [B, H, W, 3] (already normalized) -> [B, H/32, W/32, 2048] f32."""
    return _trunk(params, pack_chains(params, compute_dtype), images, compute_dtype,
                  fused_stage)


def encoder_cnn(params: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """EncoderCNN semantics: the feature map flattened to region tokens
    [B, (H/32)*(W/32), 2048]."""
    fmap = resnet_apply(params, images, compute_dtype)
    B, h, w, C = fmap.shape
    return fmap.reshape(B, h * w, C)


class CNNEncoder:
    """:func:`encoder_cnn` with its operands made once, for a caller that
    encodes many batches (the caption service): the parameters on
    ``device`` and every chain packed and cast to the compute dtype.
    Calling it runs the chains on K4 (the plain version for CPU tensors);
    :meth:`plain` runs the plain version on any device, for holding K4
    against it."""

    def __init__(self, params: Dict, compute_dtype=torch.bfloat16, device: DeviceLike = None):
        self.params = to_device(params, resolve_device(device))
        self.compute_dtype = compute_dtype
        self.chains = pack_chains(self.params, compute_dtype)

    def _run(self, images: torch.Tensor, stage: Callable) -> torch.Tensor:
        fmap = _trunk(self.params, self.chains, images, self.compute_dtype, stage)
        B, h, w, C = fmap.shape
        return fmap.reshape(B, h * w, C)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self._run(images, fused_stage)

    def plain(self, images: torch.Tensor) -> torch.Tensor:
        return self._run(images, fused_stage_plain)


# ------------------------------------------------------- int8 inference --
INT8_MIN_ROWS = 17  # torch._int_mm on the card: m > 16, k and n multiples of 8


def resnet_quantize(params: Dict, act_scales: Optional[Dict] = None) -> Dict:
    """Quantize a folded-BN ResNet for int8 inference, as captionax's
    ``resnet_quantize``: per conv, the BN scale folds into the kernel in f32
    and the folded kernel quantizes symmetrically per output channel to int8
    (``q``, ``wscale``); the bias stays f32 and the stem stays as it is.
    ``act_scales`` (from :func:`resnet_calibrate`) gives each conv a static
    activation scale ``ascale`` = max / 127; without it :func:`_qconv` takes
    the dynamic per-tensor max of its input."""
    def quantize_conv(p, amax):
        folded = p["kernel"].float() * p["scale"].float()
        wscale = torch.clamp(folded.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(folded / wscale), -127, 127).to(torch.int8)
        out = {"q": q, "wscale": wscale, "bias": p["bias"].float()}
        if amax is not None:
            amax = torch.as_tensor(amax, dtype=torch.float32, device=wscale.device)
            out["ascale"] = torch.clamp(amax / 127.0, min=1e-12)
        return out

    return {"stem": params["stem"], "stages": [
        [{k: quantize_conv(v, None if act_scales is None else act_scales["stages"][s][b][k])
          for k, v in block.items()} for b, block in enumerate(blocks)]
        for s, blocks in enumerate(params["stages"])]}


def resnet_calibrate(params: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> Dict:
    """Each conv's input max over a calibration batch (already normalized),
    from the forward of captionax's ``resnet_apply`` (every conv on
    :func:`_conv`, rounded to ``compute_dtype``): the static activation
    scales for :func:`resnet_quantize`.  Inputs beyond the calibrated range
    clip when served."""
    def amax(t):
        return t.abs().max().float()

    scales: Dict = {"stages": []}
    x = resnet_stem(params["stem"], images, compute_dtype)
    for s, blocks in enumerate(params["stages"]):
        stage_scales = []
        for b, block in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            rec = {"conv1": amax(x)}
            identity = x
            y = torch.relu(_conv(x, block["conv1"], 1, compute_dtype))
            rec["conv2"] = amax(y)
            y = torch.relu(_conv(y, block["conv2"], stride, compute_dtype))
            rec["conv3"] = amax(y)
            y = _conv(y, block["conv3"], 1, compute_dtype)
            if "downsample" in block:
                rec["downsample"] = rec["conv1"]
                identity = _conv(x, block["downsample"], stride, compute_dtype)
            x = torch.relu(y + identity)
            stage_scales.append(rec)
        scales["stages"].append(stage_scales)
    return scales


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x int8 [k, n] -> int32, exact: every sum of k <= 4608
    products of |q| <= 127 is below 2^27, which f64 holds exactly."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x int8 [k, n] -> the exact int32 sums: ``torch._int_mm``
    on the card (the int8 tensor cores), which takes m > 16 and k, n
    multiples of 8 and raises on any other shape; the plain version for CPU
    tensors."""
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    if m < INT8_MIN_ROWS or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm takes m > 16 and k, n multiples of 8; got "
                         f"m={m}, k={k}, n={n}")
    return torch._int_mm(a, b.contiguous())


def im2col(x: torch.Tensor, kh: int, stride: int) -> torch.Tensor:
    """NHWC x [B, H, W, C], a kh x kh window padded kh // 2 with zeros on
    each side -> [B, Ho, Wo, kh*kh*C], the columns in the order of an HWIO
    kernel reshaped to [kh*kh*C, O]."""
    B, Hh, W, C = x.shape
    p = kh // 2
    Ho, Wo = (Hh + 2 * p - kh) // stride + 1, (W + 2 * p - kh) // stride + 1
    if kh == 1:
        return x[:, ::stride, ::stride, :]
    xp = F.pad(x, (0, 0, p, p, p, p))
    return torch.cat([xp[:, i:i + stride * (Ho - 1) + 1:stride, j:j + stride * (Wo - 1) + 1:stride, :]
                      for i in range(kh) for j in range(kh)], dim=3)


def int8_conv(qx: torch.Tensor, q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """int8 NHWC activations x int8 HWIO kernel (pad kh // 2) -> the exact
    int32 sums [B, Ho, Wo, O]: a 1x1 conv is one product over the (strided)
    pixels, a 3x3 conv one product over its im2col columns."""
    kh, _, cin, cout = q.shape
    cols = im2col(qx, kh, stride)
    B, Ho, Wo, k = cols.shape
    y = int8_matmul(cols.reshape(B * Ho * Wo, k), q.reshape(kh * kh * cin, cout))
    return y.reshape(B, Ho, Wo, cout)


def _qconv(x: torch.Tensor, qp: Dict, stride: int = 1, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantize the activations (the static ``ascale`` when calibrated, else
    the input's max / 127; f32 division, round half to even, clip +-127),
    the exact int8 conv, then dequantize in f32 (``y * (ascale * wscale) +
    bias``) and cast once to ``compute_dtype``."""
    if "ascale" in qp:
        ascale = qp["ascale"]
    else:
        ascale = torch.clamp(x.abs().max().float() / 127.0, min=1e-12)
    qx = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(torch.int8)
    y = int8_conv(qx, qp["q"], stride)
    deq = y.float() * (ascale * qp["wscale"]) + qp["bias"]
    return deq.to(compute_dtype)


def resnet_apply_int8(qparams: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 twin of :func:`resnet_apply` over :func:`resnet_quantize`'s
    tree -> [B, H/32, W/32, 2048] f32: the stem unquantized, every bottleneck
    conv int8 x int8 -> int32, residual adds and ReLUs in ``compute_dtype``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    x = resnet_stem(qparams["stem"], images, compute_dtype)
    for s, blocks in enumerate(qparams["stages"]):
        for b, block in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            identity = x
            y = torch.relu(_qconv(x, block["conv1"], 1, compute_dtype))
            y = torch.relu(_qconv(y, block["conv2"], stride, compute_dtype))
            y = _qconv(y, block["conv3"], 1, compute_dtype)
            if "downsample" in block:
                identity = _qconv(x, block["downsample"], stride, compute_dtype)
            x = torch.relu(y + identity)
    return x.float()


def encoder_cnn_int8(qparams: Dict, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """EncoderCNN semantics over the int8 trunk -> [B, 49, 2048] region tokens."""
    fmap = resnet_apply_int8(qparams, images, compute_dtype)
    B, h, w, C = fmap.shape
    return fmap.reshape(B, h * w, C)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d over NHWC: output[i] averages input rows
    floor(i*H/out) .. ceil((i+1)*H/out)-1 (upsampling too)."""
    def pool_axis(arr, in_size, out_size, axis):
        segments = []
        for i in range(out_size):
            lo = (i * in_size) // out_size
            hi = -(-((i + 1) * in_size) // out_size)
            segments.append(arr.narrow(axis, lo, hi - lo).mean(dim=axis, keepdim=True))
        return torch.cat(segments, dim=axis)

    _, H, W, _ = x.shape
    x = pool_axis(x, H, out_hw[0], 1)
    return pool_axis(x, W, out_hw[1], 2)


def encoder_pooled(params: Dict, images: torch.Tensor, size: int = 14) -> torch.Tensor:
    """Encoder semantics: the ResNet trunk (bf16, as captionax's default)
    and an adaptive pool to (size, size) -> [B, size, size, 2048]."""
    return adaptive_avg_pool(resnet_apply(params, images), (size, size))


# ------------------------------------------------- EncoderLstm (global) --
def encoder_lstm_init(generator: torch.Generator, embed_size: int, depth: int = 50,
                      device: DeviceLike = None) -> Dict:
    """ResNet trunk, a trainable Linear(2048, E) (weight N(0, 0.02), bias 0)
    and BatchNorm1d (gamma 1, beta 0)."""
    dev = resolve_device(device)
    w = torch.randn((512 * EXPANSION, embed_size), generator=generator) * 0.02
    return {
        "resnet": resnet_init(generator, depth, device=dev),
        "embed": {"w": w.to(dev), "b": torch.zeros((embed_size,), device=dev)},
        "bn": {"gamma": torch.ones((embed_size,), device=dev),
               "beta": torch.zeros((embed_size,), device=dev)},
    }


def encoder_lstm_apply(
    params: Dict,
    images: torch.Tensor,
    train: bool = True,
    running_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    momentum: float = 0.01,
    eps: float = 1e-5,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """-> ([B, E] feature, updated running stats).  Training normalizes by
    the batch's mean and biased variance and moves the running stats by
    ``momentum`` (the variance unbiased, as BatchNorm1d); eval normalizes
    by the running stats."""
    fmap = resnet_apply(params["resnet"], images, compute_dtype)
    pooled = fmap.mean(dim=(1, 2))
    feat = pooled @ params["embed"]["w"] + params["embed"]["b"]
    if running_stats is None:
        running_stats = (torch.zeros_like(feat[0]), torch.ones_like(feat[0]))
    r_mean, r_var = running_stats
    if train:
        mean = feat.mean(dim=0)
        var = feat.var(dim=0, unbiased=False)
        n = feat.shape[0]
        r_mean = (1 - momentum) * r_mean + momentum * mean
        r_var = (1 - momentum) * r_var + momentum * var * n / max(n - 1, 1)
    else:
        mean, var = r_mean, r_var
    out = (feat - mean) / torch.sqrt(var + eps)
    return out * params["bn"]["gamma"] + params["bn"]["beta"], (r_mean, r_var)


def from_torch_state_dict(state_dict, depth: int = 152, eps: float = 1e-5,
                          device: DeviceLike = None) -> Dict:
    """A torchvision resnet state_dict (tensors or numpy arrays) -> the
    folded-BN NHWC tree used here, on ``device``.

    Folding: y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
           = conv(x) * scale + bias,  scale = gamma / sqrt(var + eps),
                                      bias  = beta - mean * scale.
    """
    dev = resolve_device(device)

    def arr(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def conv_bn(conv_name, bn_name):
        kernel = arr(conv_name + ".weight").transpose(2, 3, 1, 0)  # OIHW -> HWIO
        gamma, beta = arr(bn_name + ".weight"), arr(bn_name + ".bias")
        mean, var = arr(bn_name + ".running_mean"), arr(bn_name + ".running_var")
        scale = gamma / np.sqrt(var + eps)
        return {"kernel": tensor(kernel), "scale": tensor(scale),
                "bias": tensor(beta - mean * scale)}

    params: Dict = {"stem": conv_bn("conv1", "bn1")}
    stages: List = []
    for s, n_blocks in enumerate(BLOCKS[depth]):
        blocks = []
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            block = {
                "conv1": conv_bn(f"{pre}.conv1", f"{pre}.bn1"),
                "conv2": conv_bn(f"{pre}.conv2", f"{pre}.bn2"),
                "conv3": conv_bn(f"{pre}.conv3", f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in state_dict:
                block["downsample"] = conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1")
            blocks.append(block)
        stages.append(blocks)
    params["stages"] = stages
    return params
