"""Batch serving for the fused beam and greedy decodes.

Port of ``captionax/decode/serving.py``: the beam server (K1) and the greedy
server (K2).  :class:`PipelinedDecoder` keeps batches in
flight: each batch's kernels are queued on the current CUDA stream, its
result is copied without blocking into pinned host memory, and a CUDA
event per batch marks when that copy is done, so the host only waits on
the oldest batch while the card works on the newer ones.
:class:`MicroBatcher` coalesces concurrent single-image requests into
fixed-size batches.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.decode.search import BeamResult
from captionax_torch.ops.decode_kernel import K, BeamDecoder, GreedyDecoder


def _map_result(fn, res):
    """Apply ``fn`` to a tensor, or to each field of a BeamResult."""
    if isinstance(res, tuple):
        return type(res)(*(fn(x) for x in res))
    return fn(res)


def _start_fetch(res):
    """Queue non-blocking copies of a result into pinned host memory and
    record an event after them (CPU results need no copy)."""
    def copy(t):
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    leaves = res if isinstance(res, tuple) else (res,)
    event = None
    if any(t.device.type == "cuda" for t in leaves):
        event = torch.cuda.Event()
    host = _map_result(copy, res)
    if event is not None:
        event.record()
    return host, event


def _finish_fetch(pending) -> object:
    host, event = pending
    if event is not None:
        event.synchronize()
    return _map_result(lambda t: t.numpy(), host)


def fetch(res):
    """Result on any device -> the same structure of numpy arrays."""
    return _finish_fetch(_start_fetch(res))


class PipelinedDecoder:
    """Stream batches through ``decode_fn`` with ``depth`` batches in flight.

    Items of the stream are ``features`` or, for mixed-style servers,
    ``(features, style_rows)`` tuples splatted into ``decode_fn``.  Results
    come back as numpy (a BeamResult of arrays, or one array when packed),
    in submission order."""

    def __init__(self, decode_fn: Callable, depth: int = 1):
        self.decode_fn = decode_fn
        self.depth = max(1, depth)

    def map(self, feature_batches: Iterable) -> Iterator:
        pending = deque()
        for feats in feature_batches:
            if isinstance(feats, tuple):
                result = self.decode_fn(*feats)
            else:
                result = self.decode_fn(feats)
            pending.append(_start_fetch(result))
            if len(pending) > self.depth:
                yield _finish_fetch(pending.popleft())
        while pending:
            yield _finish_fetch(pending.popleft())


class MicroBatcher:
    """Coalesce concurrent single-caption requests into fixed-size batches.

    ``submit()`` is thread-safe and returns a ``concurrent.futures.Future``
    that resolves to the request's row of the result.  One worker thread
    owns the device: it drains up to ``batch_size`` queued requests, pads
    the batch with zero features, decodes, fetches and resolves."""

    def __init__(self, decode_fn: Callable, batch_size: int, feature_shape,
                 styled: bool = False, feature_dtype=np.float32):
        self.decode_fn = decode_fn
        self.B = batch_size
        self.styled = styled
        self._feats = np.zeros((batch_size,) + tuple(feature_shape), feature_dtype)
        self._rows = np.zeros((batch_size,), np.int32)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, features: np.ndarray, style_row: int = 0):
        from concurrent.futures import Future

        fut: Future = Future()
        self._q.put((features, style_row, fut))
        return fut

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self):
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                continue
            pending = [item]
            while len(pending) < self.B:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is not None:
                    pending.append(nxt)
            # a bad request must fail its futures, not kill the worker (a
            # dead worker would hang every later submit())
            try:
                n = len(pending)
                for i, (f, row, _) in enumerate(pending):
                    self._feats[i] = f
                    self._rows[i] = row
                self._feats[n:] = 0.0
                if self.styled:
                    res = self.decode_fn(self._feats, self._rows)
                else:
                    res = self.decode_fn(self._feats)
                host = fetch(res)
            except Exception as e:  # noqa: BLE001 — handed to the callers
                for _, _, fut in pending:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for i, (_, _, fut) in enumerate(pending):
                fut.set_result(_map_result(lambda a, i=i: a[i], host))


def pack_beam_result(res: BeamResult) -> torch.Tensor:
    """BeamResult -> one int32 tensor [B, T+3]: tokens ‖ length ‖ found ‖
    score bits, so a batch comes back to the host in one copy."""
    score_bits = res.scores.float().contiguous().view(torch.int32)
    return torch.cat(
        [
            res.tokens.to(torch.int32),
            res.lengths[:, None].to(torch.int32),
            res.found[:, None].to(torch.int32),
            score_bits[:, None],
        ],
        dim=1,
    )


def unpack_beam_result(packed: np.ndarray) -> BeamResult:
    """Inverse of :func:`pack_beam_result` on the host (numpy)."""
    packed = np.ascontiguousarray(packed)
    return BeamResult(
        packed[:, :-3],
        np.ascontiguousarray(packed[:, -1]).view(np.float32),
        packed[:, -2].astype(bool),
        packed[:, -3],
    )


def make_beam_server(
    decoder_params,
    gru_params=None,
    k: int = K,
    max_steps: int = 50,
    packed: bool = False,
    f32: bool = False,
    device: DeviceLike = None,
) -> PipelinedDecoder:
    """A styled-caption beam server on the K1 kernels (weights packed once,
    at build).  With ``packed=True`` the stream yields single int32 arrays
    (use :func:`unpack_beam_result`).  Mixed styles: pass ``gru_params`` as
    a theta bank with a leading style axis; the stream then takes
    ``(features, style_rows)`` tuples.  The kernels decode beam width
    ``K`` only; another ``k`` raises."""
    if k != K:
        raise ValueError(f"the beam kernels decode k={K}, not k={k}")
    decoder = BeamDecoder(decoder_params, gru_params, max_steps=max_steps, f32=f32,
                          device=resolve_device(device))

    def decode(f, rows=None):
        return decoder(f, rows)

    if packed:
        return PipelinedDecoder(lambda *a: pack_beam_result(decode(*a)))
    return PipelinedDecoder(decode)


def make_greedy_server(
    decoder_params,
    gru_params=None,
    max_len: int = 20,
    f32: bool = False,
    device: DeviceLike = None,
) -> PipelinedDecoder:
    """A styled-caption greedy server on the K2 kernels (weights packed
    once, at build); the stream yields int32 token arrays [B, max_len].  A
    theta-bank ``gru_params`` makes the stream take ``(features,
    style_rows)`` tuples, as the beam server does."""
    decoder = GreedyDecoder(decoder_params, gru_params, max_len=max_len, f32=f32,
                            device=resolve_device(device))

    def decode(f, rows=None):
        return decoder(f, rows)

    return PipelinedDecoder(decode)
