"""Device selection and profiling helpers of the port's entry points.

``device=None`` means the card: the port runs on an NVIDIA GPU unless the
caller asks for the CPU.  A missing card is an error, never a silent fall
back to the CPU.

The profiling helpers follow ``captionax/core/runtime.py``: :func:`trace`
writes a ``torch.profiler`` Chrome trace, :func:`device_barrier` waits for
the card, :func:`device_time` times a call with CUDA events,
:class:`StepTimer` keeps per-step wall times and :func:`host_rss_mb` reads
the process's resident set.  captionax's ``setup_runtime`` (JAX's
persistent compilation cache) has no counterpart: the port compiles its
kernels once per build directory (``ops/_cuda.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


@contextlib.contextmanager
def trace(log_dir: str = "captionax-trace"):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); the trace is written as ``<log_dir>/trace.json`` (open it in
    Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    vals = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    for v in vals:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def device_barrier(x) -> None:
    """Wait until the card has finished the work queued on the device of
    ``x``'s first tensor (a tensor or a tree of them); no-op on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def device_time(fn, *args, k: int = 4, iters: int = 5) -> float:
    """Card seconds for one ``fn(*args)``: ``k`` calls between two CUDA
    events on the device of the arguments' first tensor, the least of
    ``iters`` such readings, divided by ``k`` (after one warm call).  Where
    that tensor lies on the CPU (or there is none) the host clock stands in."""
    fn(*args)
    t = _first_tensor(args)
    if t is None or t.device.type != "cuda":
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(k):
                fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best / k
    with torch.cuda.device(t.device):
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best / k


def host_rss_mb() -> float:
    """Current process resident-set size in MB (0.0 if unreadable); the
    harness logs it per epoch."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024, 1)
    except OSError:
        pass
    return 0.0


class StepTimer:
    """Per-step wall timing with percentile summaries; ``stop(result)``
    waits for the card to finish ``result`` first."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            device_barrier(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            "p90_ms": ts[min(int(n * 0.9), n - 1)] * 1e3,
            "max_ms": ts[-1] * 1e3,
        }
