"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

The kernels have a plain C interface: one ``nvcc`` call compiles every
``csrc/*.cu`` (``beam_decode.cu``: the cell step and K1; ``greedy_decode.cu``:
K2; ``train_recurrence.cu``: K3, the recurrence of training forward and
backward; all include ``decode_common.cuh``) for ``sm_90a`` into one shared
library under ``captionax_torch/_build/`` at first use, and ``ctypes`` loads
it.  The library's file name carries a hash of every source and header and
of the flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entries and their argument types: every pointer and the stream is a
# c_void_p (a bare Python int would be cut to 32 bits), every size a c_int.
SIGNATURES = {
    "cell_step_f32": [_P] * 5 + [_I] + [_P] * 10 + [_I] * 9 + [_P],
    "cell_step_bf16": [_P] * 5 + [_I] + [_P] * 10 + [_I] * 9 + [_P],
    "logits_top3_partial_f32": [_P] * 8 + [_I] * 3 + [_P],
    "logits_top3_partial_bf16": [_P] * 8 + [_I] * 3 + [_P],
    "beam_select": [_P] * 15 + [_I] * 6 + [_P],
    "logits_top1_partial_f32": [_P] * 6 + [_I] * 3 + [_P],
    "logits_top1_partial_bf16": [_P] * 6 + [_I] * 3 + [_P],
    "greedy_select": [_P] * 8 + [_I] * 6 + [_P],
    "train_fwd_f32": [_P] * 12 + [_I] * 7 + [_P],
    "train_fwd_bf16": [_P] * 12 + [_I] * 7 + [_P],
    "train_bwd_recurrence_f32": [_P] * 23 + [_I] * 7 + [_P],
    "train_bwd_recurrence_bf16": [_P] * 23 + [_I] * 7 + [_P],
    "train_wgrad_partial": [_P] * 6 + [_I] * 4 + [_P],
    "train_wgrad_reduce": [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_P],
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


def build() -> BuildInfo:
    """Compile the library unless these sources and flags are built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"libdecode_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             *(str(p) for p in sources() if p.suffix == ".cu")],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


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


class KernelOp:
    """One kernel of the library (in its f32 and bf16 instances) with a
    count of its launches.  ``launches`` grows by one per successful launch
    and nowhere else; callers may reset it to 0."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def launch(self, symbol: str, *args) -> None:
        lib = library()
        rc = getattr(lib, symbol)(*args)
        if rc != 0:
            msg = lib.decode_error_string(rc).decode()
            raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
        self.launches += 1
