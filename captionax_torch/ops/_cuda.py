"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

The kernels have a plain C interface.  At first use every ``csrc/*.cu``
(``beam_decode.cu``: the cell step and K1; ``greedy_decode.cu``: K2;
``train_recurrence.cu``: K3, the recurrence of training forward and
backward, on thread-block clusters; the three include ``decode_common.cuh``; ``conv_stage.cu``: K4,
the encoder's bottleneck chains; K4 and the bf16 vocab products of K1 and
K2 share the ``wgmma`` helpers of ``wgmma_common.cuh``) is compiled for ``sm_90a`` by an ``nvcc``
process of its own, all started together, and one more ``nvcc`` call links
the objects into one shared library under ``captionax_torch/_build/``,
which ``ctypes`` loads.  The library's file name carries a hash of every
source and header and of the flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)
BUILD_TIMEOUT_S = 600

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entries and their argument types: every pointer and the stream is a
# c_void_p (a bare Python int would be cut to 32 bits), every size a c_int.
SIGNATURES = {
    "cell_step_f32": [_P] * 5 + [_I] + [_P] * 10 + [_I] * 9 + [_P],
    "cell_step_bf16": [_P] * 5 + [_I] + [_P] * 10 + [_I] * 12 + [_P],
    "logits_top3_partial_f32": [_P] * 8 + [_I] * 3 + [_P],
    "logits_top3_partial_bf16": [_P] * 8 + [_I] * 4 + [_P],
    "beam_select": [_P] * 15 + [_I] * 7 + [_P],
    "logits_top1_partial_f32": [_P] * 6 + [_I] * 3 + [_P],
    "logits_top1_partial_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "greedy_select": [_P] * 8 + [_I] * 8 + [_P],
    "train_fwd_f32": [_P] * 11 + [_I] * 8 + [_P],
    "train_fwd_bf16": [_P] * 11 + [_I] * 8 + [_P],
    "train_bwd_recurrence_f32": [_P] * 25 + [_I] * 8 + [_P],
    "train_bwd_recurrence_bf16": [_P] * 25 + [_I] * 8 + [_P],
    "train_feats_fold_f32": [_P] * 3 + [_I] * 10 + [_P],
    "train_feats_fold_bf16": [_P] * 3 + [_I] * 10 + [_P],
    "train_wgrad_partial": [_P] * 6 + [_I] * 4 + [_P],
    "train_wgrad_reduce": [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_P],
    "conv_stage_f32": [_P] * 16 + [_I] * 7 + [_P, _P],
    "conv_stage_bf16": [_P] * 16 + [_I] * 7 + [_P, _P] + [_I] * 2,
    # sizes, not kernels: the dynamic shared memory of a kernel, in bytes
    "conv_stage_bf16_smem": [_I],
    "vocab_product_smem": [_I],
    "cell_attend_smem": [_I] * 4,
    "cell_gates_smem": [_I] * 4,
    "train_wgrad_smem": [],
    "train_recurrence_smem": [_I] * 7,
    # the clusters of a recurrence kernel the card runs at once
    "train_recurrence_clusters": [_I] * 7,
    # the blocks of a fold instance an SM runs at once
    "train_feats_fold_resident": [_I] * 4,
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float      # nvcc wall time, 0.0 when the library was already built
    log: str            # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> List[Path]:
    """The files the library is built from: every .cu and .cuh of csrc."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _run_all(commands: List[List[str]]) -> str:
    """Run the commands side by side; -> their joined output.  Raises (and
    kills the ones still running) when one fails or takes too long."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)  # a group: nvcc's own children too
             for cmd in commands]
    logs = []
    try:
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        for cmd, proc in zip(commands, procs):
            log, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return "".join(logs)


def build() -> BuildInfo:
    """Compile the library unless these sources and flags are built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"libdecode_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        units = [p for p in sources() if p.suffix == ".cu"]
        objs = [str(work / f"{p.stem}.o") for p in units]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for p, o in zip(units, objs)])
        tmp = str(work / out.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return BuildInfo(out, time.perf_counter() - t0, log)


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.decode_error_string.argtypes = [ctypes.c_int]
        lib.decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def call(symbol: str, *args) -> None:
    """Call one C entry of the library; raise on the CUDA error it returns."""
    lib = library()
    rc = getattr(lib, symbol)(*args)
    if rc != 0:
        msg = lib.decode_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")


class KernelOp:
    """One kernel of the library (in its f32 and bf16 instances) with a
    count of its launches.  ``launches`` grows by one per successful launch
    and nowhere else (K4's wrapper adds the launches its C entry reports);
    callers may reset it to 0."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, symbol: str, *args) -> None:
        call(symbol, *args)
        self.launches += 1
