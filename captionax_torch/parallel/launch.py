"""Start the ranks of a data-parallel run and collect rank 0's result.

captionax drives every device of ``--mesh-data N`` from one process; the
port trains with one process per rank over ``torch.distributed``, and
:func:`launch` is the plumbing between the two.  It starts N ranks with
``torch.multiprocessing`` and the ``spawn`` start method (forking a parent
that has initialised CUDA breaks; each child makes its own CUDA context),
empties the parent's CUDA cache first, and has the ranks meet over a
``FileStore`` in a temporary directory, so no port is needed.  The backend
follows from the devices (``mesh.backend_for``): NCCL where every rank has
a card of its own, gloo where ranks share one (the CPU, or the one card of
a one-card machine; gloo's collectives take CUDA tensors).  A backend that
fails to start raises; nothing falls back to another.  An exception in any
rank ends every rank, and the call raises with the traceback of the rank
that failed first.  Ranks other than 0 print nothing.  Each rank takes the
parent's TF32 settings and its intra-op thread count, so the ranks compute
as the parent would.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from captionax_torch.parallel import mesh as pmesh

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer fails


def _rank_main(rank: int, world: int, devices: List[str], backend: str, tmp: str,
               fn: Callable, args: tuple, settings: tuple) -> None:
    if rank:
        sys.stdout = open(os.devnull, "w")
    tf32_matmul, tf32_cudnn, threads = settings
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_matmul, tf32_cudnn
    torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        out = fn(*args)
    except BaseException:
        # the first rank to fail is the one to report: the others may fail
        # after it, inside a collective it left
        with open(os.path.join(tmp, f"error{rank}.pkl"), "wb") as f:
            pickle.dump((time.time(), traceback.format_exc()), f)
        raise
    else:
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _first_error(tmp: str, n: int):
    """(rank, traceback) of the rank that failed first, or None."""
    errors = []
    for r in range(n):
        path = os.path.join(tmp, f"error{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                errors.append((*pickle.load(f), r))
    if not errors:
        return None
    _, tb, rank = min(errors)
    return rank, tb


def launch(fn: Callable, n: int, args: tuple = (), devices: Optional[Sequence] = None,
           device=None) -> Any:
    """``fn(*args)`` on ``n`` ranks, rank r on ``devices[r]`` (default:
    ``mesh.default_devices(n, device)``); -> rank 0's return value, which
    must pickle.  ``fn`` must be importable by name (a module's function);
    a rank builds its mesh with ``make_mesh(devices=...)`` on the same
    list."""
    devices = [str(d) for d in (devices or pmesh.default_devices(n, device))]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    backend = pmesh.backend_for(devices)
    print(f"data parallel: {n} ranks over {backend} on {', '.join(devices)}", flush=True)
    if any(torch.device(d).type == "cuda" for d in devices):
        from captionax_torch.ops import _cuda

        _cuda.build()  # once here, not once per rank
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    # the ranks compute as this process would: its TF32 settings and its
    # intra-op thread count go with them (ranks that share the CPU at its
    # full thread count each would oversubscribe it)
    settings = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.get_num_threads())
    tmp = tempfile.mkdtemp(prefix="captionax-ranks-")
    try:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, args=(n, devices, backend, tmp, fn, tuple(args), settings), nprocs=n,
                join=True, start_method="spawn")
        except Exception as e:
            first = _first_error(tmp, n)
            if first is None:
                raise
            raise RuntimeError(f"rank {first[0]} of {n} failed first:\n{first[1]}") from e
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
