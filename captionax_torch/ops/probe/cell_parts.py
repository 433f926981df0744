"""Split the time of the old cell kernel (a) into its parts on the card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m captionax_torch.ops.probe.cell_parts

It builds ``cell_parts.cu`` (the cell kernel as it stood before its
redesign on the tensor cores, with switches that leave out one part at a
time) with nvcc into ``captionax_torch/_build/``, and times it with CUDA
events at the decode's four shapes (bf16 weights, full width): beam and
greedy rows at B=1024 with one theta, and the caption service's B=64 with
an S=3 bank.  Two splits, since leaving a part out changes how the
compiler builds the rest: a part's time as the whole kernel's less the
kernel's without it ("left out"), and as the kernel's with that part alone
less the kernel's with none of the three ("alone").  Prints one line per
shape and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from captionax_torch.ops import _cuda

HERE = Path(__file__).resolve().parent
R, F, E, H = 49, 200, 200, 200
# name: (rows, rows per image, bank size S, rows per block) as the decoders launch them
SHAPES = {
    "beam, B=1024": (3072, 3, 1, 12),
    "greedy, B=1024": (1024, 1, 1, 3),
    "service beam, B=64, S=3": (192, 3, 3, 12),
    "service greedy, B=64, S=3": (64, 1, 3, 3),
}
MODES = {"whole": 0, "no U_a": 1, "no attention": 2, "no gates": 4, "none of the three": 7,
         "U_a alone": 6, "attention alone": 5, "gates alone": 3}


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "libcell_parts.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(HERE / "cell_parts.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.cell_parts_bf16.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.cell_parts_bf16.restype = ctypes.c_int
    return lib


def operands(rows: int, rpi: int, S: int, g: torch.Generator):
    dev, bf = "cuda", torch.bfloat16
    B, In, G = rows // rpi, E + F, 3 * H

    def rnd(*shape, scale=0.1, dtype=bf):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    return [
        rnd(B, R, F), rnd(B, R, H), torch.tanh(torch.randn((rows, H), generator=g)).cuda(),
        torch.randint(0, 9728, (rows,), generator=g, dtype=torch.int32).cuda(),
        torch.randint(0, S, (B,), generator=g, dtype=torch.int32).cuda(),
        rnd(9728, E), rnd(H, H), rnd(H, dtype=torch.float32), rnd(H, dtype=torch.float32),
        rnd(S, In, G), rnd(S, H, G), rnd(S, G, dtype=torch.float32),
        rnd(S, G, dtype=torch.float32), torch.empty((rows, H), device=dev),
    ]


def device_ms(fn, iters: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lib = build()
    g = torch.Generator().manual_seed(0)
    record = {}
    for name, (rows, rpi, S, rt) in SHAPES.items():
        ops = operands(rows, rpi, S, g)
        ptrs = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
        stream = torch.cuda.current_stream().cuda_stream

        def call(mode):
            rc = lib.cell_parts_bf16(ptrs, rows, rpi, R, F, E, H, S, rt, mode, stream)
            if rc:
                raise RuntimeError(f"cell_parts_bf16: CUDA error {rc}")

        ms = {k: device_ms(lambda m=m: call(m)) for k, m in MODES.items()}
        none = ms["none of the three"]
        names = ("U_a", "attention", "gates")
        parts = {"left out": {k: ms["whole"] - ms[f"no {k}"] for k in names},
                 "alone": {k: ms[f"{k} alone"] - none for k in names}}
        record[name] = {"ms": ms, "parts": parts}
        print(f"{name} ({rows} rows, {rt} a block): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()) + "; parts "
              + "; ".join(f"{how}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in d.items())
                          for how, d in parts.items()) + f" [{card}]",
              flush=True)
    print(json.dumps({"card": card, "cell_parts": record}))


if __name__ == "__main__":
    main()
