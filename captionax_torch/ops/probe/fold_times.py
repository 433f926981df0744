"""Time K3's d_feats fold ``train_feats_fold`` on the card, beside one
``torch.bmm`` of the same sum, its bound, the launch floor and the fold's
first design.

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m captionax_torch.ops.probe.fold_times

or, to time another tree's fold with this script,
``PYTHONPATH=<tree> python3 captionax_torch/ops/probe/fold_times.py`` (it
calls only ``train_kernel.feats_fold``, whose signature every tree of the
port has).  It builds the library of the ``captionax_torch`` it imports,
and ``fold_probe.cu`` with ``launch_floor.cu`` (this directory) with nvcc,
and times with CUDA events, on seeded random operands (w_t a softmax over
the regions, dctx_t ~ 1e-2 N(0, 1)) at the training shapes T=25, R=49,
F=200 and B = 1024 and 64, f32 and bf16:

- the tree's ``feats_fold`` (and its ``fold_plan`` where it has one);
- ``torch.bmm`` of w_t^T and dctx_t (the same sum in another order);
- the fold's first design (``fold_probe.cu``) whole, with its loads alone
  and with its arithmetic alone: what bounded it;
- an empty kernel of the fold's grid and threads (the launch floor);
- the bound: the bytes (each operand read once, d_feats written once) over
  3.35 TB/s, against the FLOPs over the dtype's peak.

Prints one line per measurement, the ptxas lines of the fold's kernels when
it built the library, and one JSON line.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
from pathlib import Path

import torch

from captionax_torch.ops import _cuda
from captionax_torch.ops import train_kernel as tk

HERE = Path(__file__).resolve().parent
T, R, F = 25, 49, 200
SIZES = (1024, 64)      # the full-width batch; captionax's default training batch
ITERS = 200
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
MODES = ("whole", "loads alone", "arithmetic alone")


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time per call: the card sleeps while the host queues the
    calls, so the events measure the launches back to back."""
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


@functools.lru_cache(maxsize=None)
def probe_library() -> ctypes.CDLL:
    """``fold_probe.cu`` and ``launch_floor.cu`` built with nvcc, once a process."""
    out = _cuda.BUILD_DIR / "libfold_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(HERE / "fold_probe.cu"), str(HERE / "launch_floor.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.old_fold.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.old_fold.restype = lib.empty_launch.restype = ctypes.c_int
    return lib


def _checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def operands(b: int, cdt, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w_t = torch.softmax(torch.randn((b, T, R), generator=g, device="cuda") * 2, dim=2)
    return w_t, (torch.randn((b, T, F), generator=g, device="cuda") * 1e-2).to(cdt)


def measure(b: int, cdt) -> dict:
    """The readings at b images in the compute dtype ``cdt``."""
    lib = probe_library()
    stream = torch.cuda.current_stream().cuda_stream
    w_t, dctx_t = operands(b, cdt)
    out = torch.empty((b, R, F), dtype=cdt, device="cuda")
    bf16 = int(cdt == torch.bfloat16)

    def old(mode):
        _checked(lib.old_fold(bf16, w_t.data_ptr(), dctx_t.data_ptr(), out.data_ptr(), b, T, R,
                              F, mode, stream), "old_fold")

    plain = tk.feats_fold_plain(w_t, dctx_t)
    got = tk.feats_fold(w_t, dctx_t)
    old(0)
    rec = {"equal": bool(torch.equal(got, plain)), "first_design_equal": bool(torch.equal(out, plain))}
    rec["ms"] = device_ms(lambda: tk.feats_fold(w_t, dctx_t))
    w_mat = w_t.transpose(1, 2).to(cdt)
    rec["bmm_ms"] = device_ms(lambda: torch.bmm(w_mat, dctx_t))
    rec["first_design_ms"] = {m: device_ms(lambda: old(i)) for i, m in enumerate(MODES)}
    n_bytes = (w_t.numel() * 4 + dctx_t.numel() * dctx_t.element_size()
               + b * R * F * dctx_t.element_size())
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, 2 * b * T * R * F / PEAK_FLOPS[cdt] * 1e3
    rec["bound_ms"], rec["bound_by"] = (tb, "bytes") if tb >= tf else (tf, "operations")
    plan = getattr(tk, "card_fold_plan", None)
    if plan is not None:  # the wrapper's launch
        p = tk.card_fold_plan(torch.device("cuda", 0), b, T, R, F, cdt)
        rec["plan"] = p._asdict()
        grid, threads = p.grid, p.threads
    else:
        grid, threads = -(-b * R * F // (8 if bf16 else 4) // 256), 256
    rec["floor_ms"] = device_ms(lambda: _checked(lib.empty_launch(grid, threads, stream),
                                                 "empty_launch"))
    if hasattr(tk, "FOLD_SKIP_ARITH"):
        rec["parts_ms"] = {name: device_ms(lambda: tk.feats_fold(w_t, dctx_t, skip=bits))
                           for name, bits in PARTS.items()
                           if bits <= (7 if hasattr(tk, "FOLD_SKIP_STORE") else 3)}
        rec["plans_ms"] = {}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for regions, sets, chunk_blocks in PLANS:
            p = other_plan(b, cdt, regions, sets, chunk_blocks)
            if p.threads > tk.FOLD_THREADS:
                continue
            for grid in sorted({min(p.items, sms * n) for n in GRIDS_PER_SM} | {p.items}):
                q = p._replace(grid=grid)
                rec["plans_ms"][str(tuple(q))] = device_ms(lambda: launch(w_t, dctx_t, out, q))
    return rec


# the fold with parts left out (train_kernel.FOLD_SKIP_* bits: 1 the
# arithmetic, 2 the copies to shared memory, 4 the stores), by what is left
PARTS = {"loads and stores": 1, "arithmetic and stores": 2, "stores": 3,
         "loads and arithmetic": 4, "loads": 5, "arithmetic": 6, "none": 7}

# other launches of the fold at T, R, F (regions an item, region sets,
# feature blocks), each with an item a block and with at most 1-4 blocks an
# SM taking the items in turn, timed beside fold_plan's
PLANS = ((49, 7, 1), (49, 13, 1), (49, 13, 2), (49, 7, 2), (25, 7, 1), (25, 13, 1), (9, 2, 1),
         (49, 13, 3), (49, 25, 3), (49, 49, 3), (49, 13, 5), (49, 25, 5), (49, 49, 5),
         (25, 13, 3), (25, 25, 3), (49, 25, 8), (49, 49, 8))
GRIDS_PER_SM = (2, 4, 8)


def other_plan(b, cdt, regions, sets, chunk_blocks):
    nv = F // (8 if cdt == torch.bfloat16 else 4)
    chunks = -(-nv // chunk_blocks)
    per = -(-regions // sets)
    items = b * -(-R // regions) * -(-nv // chunks)
    return tk.FoldPlan(regions, chunks, sets, per, sets * chunks, items, items,
                       2 * T * (chunks + sets * -(-per // 4)) * 16)


def launch(w_t, dctx_t, out, p):
    name = "f32" if dctx_t.dtype == torch.float32 else "bf16"
    _cuda.call(f"train_feats_fold_{name}", w_t.data_ptr(), dctx_t.data_ptr(), out.data_ptr(),
               w_t.shape[0], T, R, F, p.regions, p.chunks, p.sets, p.grid, p.smem, 0,
               torch.cuda.current_stream().cuda_stream)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    info = _cuda.build()
    print(f"{card}; library {tk.__file__}; built in {info.seconds:.1f} s", flush=True)
    entry = None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            entry = line if "feats_fold" in line else None
        elif entry and ("registers" in line or "spill" in line):
            print("  ptxas:", entry.split("'")[1], line.strip(), flush=True)
    out = {"card": card, "tree": str(Path(tk.__file__).resolve().parents[2])}
    for b in SIZES:
        for cdt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            rec = out[f"{name} B={b}"] = measure(b, cdt)
            fd = rec["first_design_ms"]
            print(f"  {name} B={b}: train_feats_fold {rec['ms']:.4f} ms (equal to plain: "
                  f"{rec['equal']}), torch.bmm {rec['bmm_ms']:.4f}, bound {rec['bound_ms']:.4f} "
                  f"by {rec['bound_by']} ({rec['bound_ms'] / rec['ms']:.1%}), launch floor "
                  f"{rec['floor_ms']:.4f}; first design "
                  + ", ".join(f"{m} {v:.4f}" for m, v in fd.items())
                  + f" (equal: {rec['first_design_equal']}); plan {rec.get('plan')} [{card}]",
                  flush=True)
            if "parts_ms" in rec:
                print(f"    by part: " + ", ".join(f"{k} {v:.4f}" for k, v in rec["parts_ms"].items())
                      + "; other plans (regions, chunks, sets, per thread, threads, items, grid, "
                      "smem): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in rec["plans_ms"].items()), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
