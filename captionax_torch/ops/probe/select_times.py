"""Time the decode's select kernels (c) ``beam_select`` and (c1)
``greedy_select`` on the card, beside the launch floor.

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m captionax_torch.ops.probe.select_times

or, to time another tree's kernels with this script,
``PYTHONPATH=<tree> python3 captionax_torch/ops/probe/select_times.py``
(the script uses only the decode wrappers that every tree of the port
has).  It builds the library of the ``captionax_torch`` it imports and
``launch_floor.cu`` (an empty kernel) with nvcc, and times with CUDA events
at the decode's shapes, bf16 weights at full width (H=200, V=9684, seeded
random weights): K1c and K2c at B=1024 (3072 beam rows, 1024 greedy rows)
and at the caption service's B=64 (192 and 64 rows), each at step 1 on
the state the kernels left after step 0 with the exit flags open; the
launch floor at the select kernels' grids; a whole beam and greedy step
((a), (b), (c) back to back); and the host time of one select call.  Where
the tree has them it also times (c) at each images-per-block, (c1) at each
warps-per-block, and (c1)'s select, step and host time with its
programmatic dependent launch (PDL) (``measure``); and the greedy server's
captions per second at B=1024, with (c1)'s PDL off and on in turns where
the tree has the switch (``served_greedy``).  Prints one line per
measurement and one JSON line.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import subprocess
import time
from pathlib import Path

import torch

from captionax_torch.models.decoder import attention_gru_init
from captionax_torch.ops import _cuda
from captionax_torch.ops import decode_kernel as dk

HERE = Path(__file__).resolve().parent
NF, FO, E, H, V, R = 2048, 200, 200, 200, 9684, 49
MAX_STEPS, MAX_LEN, END = 50, 20, 2
SIZES = (1024, 64)  # bench.py's batch; the caption service's micro-batch
ITERS = 200


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
def floor_library() -> ctypes.CDLL:
    """``launch_floor.cu`` built with nvcc, once a process."""
    out = _cuda.BUILD_DIR / "liblaunch_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(HERE / "launch_floor.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def launch_floor_ms(lib: ctypes.CDLL, blocks: int, threads: int) -> float:
    """Back-to-back time of an empty kernel of ``blocks`` x ``threads``."""
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.empty_launch(blocks, threads, stream)
        if rc:
            raise RuntimeError(f"empty_launch: CUDA error {rc}")

    return device_ms(call)


# (blocks, threads) of the empty kernel: one warp; the new (c) at B=64 (one
# image a block) and B=1024 (four); (c1) and the old (c) at B=64 and B=1024
FLOOR_GRIDS = ((1, 32), (64, 96), (256, 384), (16, 128), (256, 128), (768, 128))


@contextlib.contextmanager
def forced(**attrs):
    """Set attributes of the decode module for the duration."""
    old = {k: getattr(dk, k) for k in attrs}
    try:
        for k, v in attrs.items():
            setattr(dk, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(dk, k, v)


def model(seed: int = 0):
    decoder = attention_gru_init(torch.Generator().manual_seed(seed), NF, FO, E, H, V,
                                 device="cuda")
    decoder["fc"]["b"][END] += 0.26  # some captions end early, most rows stay live
    return decoder


def step_calls(kind: str, decoder, B: int):
    """(select, step) for a decode of B images at step 1, on the state the
    kernels left after step 0, the exit flags open: ``select`` launches (c)
    or (c1) on the partials of step 1, ``step`` runs (a), (b) and (c) or
    (c1).  Each call repeats the same work."""
    raw = torch.randn((B, R, NF), generator=torch.Generator().manual_seed(B)).cuda()
    if kind == "beam":
        dec = dk.BeamDecoder(decoder, None, max_steps=MAX_STEPS, device="cuda")
        cell = functools.partial(dk.cell_step, block_rows=dk.K * dec.block_images)
        logits, select = dk.logits_top3_partial, dk.beam_select
    else:
        dec = dk.GreedyDecoder(decoder, None, max_len=MAX_LEN, device="cuda")
        cell = functools.partial(dk.cell_step, zero_word_t0=False,
                                 block_rows=dk.GREEDY_BLOCK_ROWS)
        logits, select = dk.logits_top1_partial, dk.greedy_select
    feats, att1, h0, styles = dec.prepare(raw)
    w = dec.weights()
    state = (dk._init_state(h0, MAX_STEPS) if kind == "beam"
             else dk._init_greedy_state(h0, MAX_LEN))
    h1 = cell(feats, att1, state["h"], state["tok"], styles, 0, w)
    select(*logits(h1, w["fc_w"], w["fc_b"]), h1, state, 0, END)
    if kind == "beam":
        state["hist_in"], state["hist_out"] = state["hist_out"], state["hist_in"]
    state["run"].fill_(1)
    hk = cell(feats, att1, state["h"], state["tok"], styles, 1, w)
    parts = logits(hk, w["fc_w"], w["fc_b"])
    scratch = {k: v.clone() for k, v in state.items()}
    scratch_step = {k: v.clone() for k, v in state.items()}

    def one_step():
        hn = cell(feats, att1, state["h"], state["tok"], styles, 1, w)
        select(*logits(hn, w["fc_w"], w["fc_b"]), hn, scratch_step, 1, END)

    return (lambda: select(*parts, hk, scratch, 1, END)), one_step


def host_ms(fn, iters: int = ITERS) -> float:
    """Host time per call where the card keeps up (the wrapper and the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def measure(kind: str, decoder, B: int) -> dict:
    """The record of one decode kind at B images: ``select_ms``, the select
    kernel back to back (launched without PDL, as the tree's other kernels
    are) at its served launch shape, twice; where the tree has them,
    ``variants`` (each launch shape, in turns a, b, c, c, b, a), and for
    (c1) ``select_pdl_ms`` (launched with PDL, which hides part of the
    launch between two selects), ``step_ms`` / ``step_pdl_ms``, ``host_ms``
    / ``host_pdl_ms`` (a whole step's device time, and the host time of one
    select call, without and with it, in turns)."""
    select, step = step_calls(kind, decoder, B)
    pdl = kind == "greedy" and hasattr(dk, "GREEDY_SELECT_PDL")
    rec = {}
    with forced(**({"GREEDY_SELECT_PDL": False} if pdl else {})):
        rec["select_ms"] = [device_ms(select), device_ms(select)]
        if kind == "beam" and hasattr(dk, "select_images_per_block"):
            choices = [(f"images {i}", dict(select_images_per_block=lambda n, s, i=i: i))
                       for i in dk.SELECT_IMAGES]
        elif kind == "greedy" and hasattr(dk, "greedy_select_warps"):
            choices = [(f"warps {w}", dict(greedy_select_warps=lambda r, s, w=w: w))
                       for w in dk.GREEDY_SELECT_WARPS]
        else:
            choices = []
        if choices:
            rec["variants"] = {}
            for order in (choices, choices[::-1]):
                for name, attrs in order:
                    with forced(**attrs):
                        rec["variants"].setdefault(name, []).append(device_ms(select))
    if not pdl:
        rec["step_ms"] = [device_ms(step, 100), device_ms(step, 100)]
        rec["host_ms"] = [host_ms(select), host_ms(select)]
        return rec
    for key in ("select_pdl_ms", "step_ms", "step_pdl_ms", "host_ms", "host_pdl_ms"):
        rec[key] = []
    for on in (False, True, True, False):
        with forced(GREEDY_SELECT_PDL=on):
            if on:
                rec["select_pdl_ms"].append(device_ms(select))
            rec["step_pdl_ms" if on else "step_ms"].append(device_ms(step, 100))
            rec["host_pdl_ms" if on else "host_ms"].append(host_ms(select))
    return rec


def served_greedy(decoder, pairs: int = 5) -> dict:
    """Captions per second of the bf16 greedy server (``make_greedy_server``,
    B=1024, max_len 20, one style's GRU) at </s> +1.2 and +0.26: a host-clock
    reading over 6 batches after a warm-up batch; with the host's time to
    issue one decode of a direct ``GreedyDecoder`` (no sync inside), per
    issued step.  Where the tree has the switch, (c1)'s PDL off and on in
    turns (off, on, on, off) ``pairs`` times, else ``pairs`` readings.
    -> {bias: {"rate_off": [...], "rate_on": [...], "issue_us_off": [...],
    "issue_us_on": [...]}} ("off" alone without the switch)."""
    from captionax_torch.decode.serving import make_greedy_server

    cg = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.randn((1024, R, NF), generator=cg, device="cuda") for _ in range(3)]
    items = batches * 2
    switch = hasattr(dk, "GREEDY_SELECT_PDL")
    turns = (False, True, True, False) if switch else (False,)
    out = {}
    for bias in (1.2, 0.26):
        d = dict(decoder, fc={"w": decoder["fc"]["w"], "b": decoder["fc"]["b"].clone()})
        d["fc"]["b"][END] += bias - 0.26  # model() biased </s> by +0.26
        server = make_greedy_server(d, None, max_len=MAX_LEN, device="cuda")
        direct = dk.GreedyDecoder(d, None, max_len=MAX_LEN, device="cuda")
        list(server.map(batches[:1]))
        direct(batches[0])
        rec = out[f"+{bias}"] = {}
        for _ in range(pairs):
            for on in turns:
                tag = "on" if on else "off"
                with forced(**({"GREEDY_SELECT_PDL": on} if switch else {})):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n = len(list(server.map(items)))
                    rate = n * 1024 / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    direct(batches[0])
                    issue = (time.perf_counter() - t0) * 1e6 / MAX_LEN
                    torch.cuda.synchronize()
                rec.setdefault(f"rate_{tag}", []).append(rate)
                rec.setdefault(f"issue_us_{tag}", []).append(issue)
    return out


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.library()
    floor_lib = floor_library()
    record = {"card": card, "floor": {}, "beam": {}, "greedy": {}}
    for blocks, threads in FLOOR_GRIDS:
        ms = launch_floor_ms(floor_lib, blocks, threads)
        record["floor"][f"{blocks}x{threads}"] = ms
        print(f"launch floor, empty kernel of {blocks} blocks x {threads} threads: {ms:.4f} ms "
              f"[{card}]", flush=True)
    decoder = model()
    for kind in ("beam", "greedy"):
        for B in SIZES:
            out = record[kind][B] = measure(kind, decoder, B)
            rows = B * (dk.K if kind == "beam" else 1)
            print(f"{kind} at B={B} ({rows} rows): "
                  + "; ".join(f"{k} {v}" for k, v in out.items()) + f" [{card}]", flush=True)
    record["served_greedy"] = served_greedy(decoder)
    for bias, rec in record["served_greedy"].items():
        print(f"served greedy at B=1024, </s> {bias}: "
              + "; ".join(f"{k} {[round(x, 1) for x in v]}" for k, v in rec.items())
              + f" [{card}]", flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
