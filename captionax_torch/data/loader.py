"""Host -> card batch pipeline with background prefetch.

Port of ``captionax/data/loader.py``: a thread assembles the next batches
while the card computes and moves each batch's ``device_keys`` to the
device; the other keys stay on the host.  A host array is copied into
freshly pinned memory and sent with ``non_blocking=True`` on a side
stream; the consumer's stream waits on that copy's event before it uses
the batch.  Each batch gets its own pinned buffers, held until the next
batch is taken (PyTorch's pinned-memory allocator also keeps a freed
buffer until the copy's event has passed), so no buffer is reused before
its copy lands.  An exception raised while a batch is built
is raised again in the consumer.

With a ``mesh`` of ranks (``parallel/mesh.py``) each rank keeps its shard
of every batch: the rows ``mesh.shard_rows`` gives it of every array
with a leading axis (the host keys too, such as ``images`` and
``indices``, so a rank's feature cache encodes its own shard), and places
its slice of every ``device_keys`` array on its device.  Scalars and the
``replicated_keys`` (per-batch values such as ``style_id`` and the domain
vector ``domain_value``) stay whole on every rank.  ``even`` requires
every batch to divide by the data axis (training); without it the tail
batch of an evaluation splits unevenly.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.parallel.mesh import shard_rows

REPLICATED_KEYS = ("style_id", "domain_value", "probe_cls")


class BatchLoader:
    """Wrap a host batch iterable with N-deep background prefetch."""

    _SENTINEL = object()

    def __init__(
        self,
        batches: Iterable[dict],
        device: DeviceLike = None,
        prefetch: int = 2,
        device_keys: Optional[tuple] = ("images", "captions", "features"),
        mesh=None,
        replicated_keys: tuple = REPLICATED_KEYS,
        even: bool = True,
    ):
        if mesh is not None:
            if mesh.group is None and mesh.n_data > 1:
                raise ValueError("BatchLoader(mesh=...) places a rank's shard: a mesh of "
                                 "several devices in one process has no rank")
            device = mesh.local_device
        self.batches = batches
        self.mesh = mesh
        self.replicated_keys, self.even = replicated_keys, even
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread selects the device by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.prefetch = prefetch
        self.device_keys = device_keys

    def _put(self, batch: dict, stream):
        """-> (batch with ``device_keys`` on the device, copy event or None,
        the pinned host buffers that must outlive the copies)."""
        out, pinned = {}, []
        cuda = self.device.type == "cuda"
        if self.mesh is not None:
            batch = shard_rows(batch, self.mesh, replicated_keys=self.replicated_keys,
                               even=self.even)
        for k, v in batch.items():
            if not (self.device_keys and k in self.device_keys):
                out[k] = v
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            if not cuda or t.device.type != "cpu":
                out[k] = t.to(self.device)
                continue
            host = t.pin_memory()
            pinned.append(host)
            with torch.cuda.stream(stream):
                out[k] = host.to(self.device, non_blocking=True)
        event = None
        if pinned:
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, pinned

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err = []
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in self.batches:
                    if not put(self._put(batch, stream)):
                        return
            except Exception as e:  # propagate into the consumer
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        held = None  # the pinned buffers of the batch last yielded
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                out, event, held = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in out.values():
                        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                            v.record_stream(current)
                yield out
        finally:
            stop.set()
            t.join()
