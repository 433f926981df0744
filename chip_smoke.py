#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``captionax_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the kernels (K1 beam, K2 greedy, K3 the training recurrence)
with one nvcc call, holds each kernel and each whole decode against their
plain PyTorch versions and against the plain oracles that run every step
(small shapes, then the full width of the hypernet attention-GRU model),
serves batches through the port's beam and greedy servers, shows that the
early exit fires, runs hypernet train steps through K3 and through the
per-step loop, and times each kernel and each train step.  One line per phase gives the phase's
seconds.  The line before the last is a JSON ``kernels`` record; the last
line is ``{"ok": true, "device": {...}}``.  Any mismatch, a missing card or
a failed build raises, and the script exits non-zero without that last
line.
"""

from __future__ import annotations

import functools
import json
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from captionax_torch.decode.search import beam_search, greedy
from captionax_torch.decode.serving import (
    MicroBatcher,
    fetch,
    make_beam_server,
    make_greedy_server,
    pack_beam_result,
    unpack_beam_result,
)
from captionax_torch.models.decoder import attention_gru_init
from captionax_torch.models.hypernet import hypernet_apply, hypernet_init, theta_param_count
from captionax_torch.ops import _cuda
from captionax_torch.ops import decode_kernel as dk
from captionax_torch.ops import train_kernel as tk
from captionax_torch.train import steps as tsteps
from captionax_torch.train.state import (
    create_train_state,
    make_optimizer,
    tree_leaves,
    tree_unflatten,
)
from captionax_torch.train.steps import (
    make_hypernet_steps,
    style_table,
    synthesize_theta,
    synthesize_theta_batched,
)

TIME_LIMIT_S = 1100
# full width of the hypernet attention-GRU model (bench.py's configuration)
NF, FO, E, H, V, R, MAX_STEPS = 2048, 200, 200, 200, 9684, 49, 50
MAX_LEN = 20          # greedy captions (fused_greedy's default)
END = 2               # </s>
B = 1024
N_BATCHES = 3
EOS_BIAS = 1.2        # bench.py's EOS-terminating variant: fc bias +1.2 on </s> (id 2)
# With +1.2 every beam search of these random weights ends at step 1 (length
# 2).  A copy of the decoder with +0.26 instead lets some images complete at
# later steps (the share and the lengths are printed; PERF.md has the run),
# so the kernels' later steps and their history are held against the plain
# version too, single style and mixed.
MID_BIAS = 0.26
MIN_LONG = 0.01       # share of images that must complete past step 1 at +0.26
SWEEP_BIASES = (0.3, 0.35, 0.4, 0.5, 0.6, 0.8)  # steps and lengths are printed for each
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SMALL = dict(NF=64, F=24, E=24, H=24, V=301, B=6, R=9, steps=25)
SMALL_SEEDS = ((5, 0.35), (7, 0.45), (11, 0.3))
# small cases where the early exit fires before the last step, for the beam
# and for greedy (at 13 and 39 after several steps); S=3 bank cases: one
# that ends at step 1, and one where the beam runs 10 steps and greedy 19
# (lengths up to 11)
SMALL_EXIT_SEEDS = ((5, EOS_BIAS), (13, 0.4), (39, 0.4))
SMALL_BANKS = ((31, 0.6), (39, 0.2))
SMALL_SCORE_TOL = 1e-4
ORACLE_SCORE_TOL = 3e-3  # kernel vs the plain beam_search, as tests/test_decode_kernel.py
FULL_SCORE_TOL = 1e-3
FULL_AGREEMENT = 0.99

CARD = ""
DEVICE = "cuda"


def say(*parts) -> None:
    print(*parts, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            say(f"== phase {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ 1
def card_and_build():
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    CARD = smi.stdout.strip().splitlines()[0]
    say(CARD)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    info = _cuda.build()
    say(f"nvcc build: {info.seconds:.2f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
            say("  ptxas:", line.strip())
    _cuda.library()


# ------------------------------------------------------------------ 2, 3
def small_params(seed: int, bias: float):
    s = SMALL
    p = attention_gru_init(gen(seed), s["NF"], s["F"], s["E"], s["H"], s["V"],
                           device=DEVICE)
    p["fc"]["b"][2] += bias
    raw = np.random.RandomState(seed + 100).randn(s["B"], s["R"], s["NF"]).astype(np.float32)
    return p, torch.from_numpy(raw).to(DEVICE)


def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def compare_states(a, b, what: str) -> None:
    for k in a:
        if a[k].dtype.is_floating_point:
            err = (a[k] - b[k]).abs().max().item()
            require(err <= SMALL_SCORE_TOL, f"{what}: {k} differs by {err}")
        else:
            require(torch.equal(a[k], b[k]), f"{what}: {k} differs")


def check_pieces(decoder, raw, style_rows=None) -> dict:
    """Run the plain beam loop, and at every step hold each K1 kernel against
    its plain version on the same inputs, gated by the same exit flags; stop
    where the flag says the decode stopped."""
    feats, att1, h0, styles = decoder.prepare(raw, style_rows)
    w = decoder.weights()
    state = dk._init_state(h0, decoder.max_steps)
    cell = functools.partial(dk.cell_step, block_rows=dk.K * decoder.block_images)
    errs = {"cell": 0.0, "logits": 0.0, "select": 0.0, "steps": decoder.max_steps}
    for t in range(decoder.max_steps):
        live = state["run"][t:]
        if not bool(live[0]):
            errs["steps"] = t
            break
        hp = dk.cell_step_plain(feats, att1, state["h"], state["tok"], styles, t, w, live=live)
        hk = cell(feats, att1, state["h"], state["tok"], styles, t, w, live=live)
        errs["cell"] = max(errs["cell"], (hp - hk).abs().max().item())
        require(errs["cell"] <= SMALL_SCORE_TOL, f"(a) step {t}: {errs['cell']}")
        pp = dk.logits_top3_partial_plain(hp, w["fc_w"], w["fc_b"], live)
        pk = dk.logits_top3_partial(hp, w["fc_w"], w["fc_b"], live)
        require(torch.equal(pp[1], pk[1]), f"(b) step {t}: top-3 indices differ")
        e = max((pp[0] - pk[0]).abs().max().item(), (pp[2] - pk[2]).abs().max().item(),
                ((pp[3] - pk[3]).abs() / pp[3]).max().item())
        errs["logits"] = max(errs["logits"], e)
        require(e <= SMALL_SCORE_TOL, f"(b) step {t}: {e}")
        sk = clone_state(state)
        dk.beam_select_plain(*pp, hp, state, t, decoder.end_id)
        dk.beam_select(*pp, hp, sk, t, decoder.end_id)
        compare_states(state, sk, f"(c) step {t}")  # the exit flags included
        errs["select"] = max(errs["select"], (state["score"] - sk["score"]).abs().max().item())
        for st in (state, sk):
            st["hist_in"], st["hist_out"] = st["hist_out"], st["hist_in"]
    if errs["steps"] < decoder.max_steps:  # a closed gate leaves the state as it is
        sk = clone_state(state)
        t = errs["steps"]
        dk.beam_select(*pk, hk, sk, t, decoder.end_id)
        compare_states(state, sk, f"(c) gated at step {t}")
    return errs


def check_greedy_pieces(decoder, raw, style_rows=None) -> dict:
    """The same for the K2 kernels: (a) with one row per image, (b1)'s
    indices equal and values within SMALL_SCORE_TOL, (c1)'s state exact."""
    feats, att1, h0, styles = decoder.prepare(raw, style_rows)
    w = decoder.weights()
    state = dk._init_greedy_state(h0, decoder.max_len)
    cell = functools.partial(dk.cell_step, zero_word_t0=False, block_rows=dk.GREEDY_BLOCK_ROWS)
    errs = {"cell": 0.0, "logits": 0.0, "steps": decoder.max_len}
    for t in range(decoder.max_len):
        live = state["run"][t:]
        if not bool(live[0]):
            errs["steps"] = t
            break
        hp = dk.cell_step_plain(feats, att1, state["h"], state["tok"], styles, t, w,
                                zero_word_t0=False, live=live)
        hk = cell(feats, att1, state["h"], state["tok"], styles, t, w, live=live)
        errs["cell"] = max(errs["cell"], (hp - hk).abs().max().item())
        require(errs["cell"] <= SMALL_SCORE_TOL, f"(a) greedy step {t}: {errs['cell']}")
        pp = dk.logits_top1_partial_plain(hp, w["fc_w"], w["fc_b"], live)
        pk = dk.logits_top1_partial(hp, w["fc_w"], w["fc_b"], live)
        require(torch.equal(pp[1], pk[1]), f"(b1) step {t}: argmax indices differ")
        e = (pp[0] - pk[0]).abs().max().item()
        errs["logits"] = max(errs["logits"], e)
        require(e <= SMALL_SCORE_TOL, f"(b1) step {t}: {e}")
        sk = clone_state(state)
        dk.greedy_select_plain(*pp, hp, state, t, decoder.end_id)
        dk.greedy_select(*pp, hp, sk, t, decoder.end_id)
        for k in state:
            require(torch.equal(state[k], sk[k]), f"(c1) step {t}: {k} differs")
    return errs


def compare_results(got, ref, score_tol: float, what: str) -> None:
    g = [x.cpu() for x in got]
    r = [x.cpu() for x in ref]
    require(torch.equal(g[0], r[0]), f"{what}: tokens differ")
    require(torch.equal(g[2], r[2]), f"{what}: found differs")
    require(torch.equal(g[3], r[3]), f"{what}: lengths differ")
    err = (g[1] - r[1]).abs().max().item()
    require(err <= score_tol, f"{what}: scores differ by {err}")


def small_bank(seed: int, bias: float):
    s = SMALL
    p, raw = small_params(seed, bias)
    hn = hypernet_init(gen(seed + 1), s["E"], s["E"] + s["F"], s["H"], device=DEVICE)
    bank = synthesize_theta_batched({"decoder": p, "hn": hn},
                                    p["embed"][torch.tensor([4, 3, 6], device=DEVICE)])
    rows = torch.tensor([0, 1, 2, 2, 1, 7], dtype=torch.int32)  # 7 clamps to 2
    theta_rows = {k: v[rows.clamp(0, 2).to(DEVICE).long()] for k, v in bank.items()}
    return p, raw, bank, rows, theta_rows


def small_exactness():
    """K1: each kernel against its plain version at every step, the whole
    decode against the plain version and against the plain ``beam_search``
    (which runs every step, so the early exit must leave the result as it
    is); the exit must fire on the SMALL_EXIT_SEEDS cases."""
    s = SMALL
    for seed, bias in SMALL_SEEDS + SMALL_EXIT_SEEDS:
        p, raw = small_params(seed, bias)
        dec = dk.BeamDecoder(p, None, max_steps=s["steps"], f32=True, block_images=4,
                             device=DEVICE)
        errs = check_pieces(dec, raw)
        got = dec(raw)
        steps = int(dec.last_steps)
        ref = dec.forward_plain(raw)
        require(int(dec.last_steps) == steps == errs["steps"], f"seed {seed}: steps differ")
        compare_results(got, ref, SMALL_SCORE_TOL, f"seed {seed}")
        oracle = beam_search(p, raw, k=dk.K, max_steps=s["steps"], device=DEVICE)
        compare_results(got, oracle, ORACLE_SCORE_TOL, f"seed {seed} vs beam_search")
        if (seed, bias) in SMALL_EXIT_SEEDS:
            require(steps < s["steps"], f"seed {seed}, bias {bias}: no early exit")
        say(f"  seed {seed}, </s> +{bias}: pieces max err {errs}; whole decode equal to the "
            f"plain version and to beam_search after {steps}/{s['steps']} steps, "
            f"found {got.found.int().tolist()} lengths {got.lengths.tolist()}")
    # S=3 theta banks with one out-of-range style row
    for seed, bias in SMALL_BANKS:
        p, raw, bank, rows, _ = small_bank(seed, bias)
        for bi in dk.TILE_IMAGES:
            dec = dk.BeamDecoder(p, bank, max_steps=s["steps"], f32=True, block_images=bi,
                                 device=DEVICE)
            errs = check_pieces(dec, raw, rows)
            compare_results(dec(raw, rows), dec.forward_plain(raw, rows), SMALL_SCORE_TOL,
                            f"bank {seed}, block_images {bi}")
            say(f"  S=3 bank {seed}, </s> +{bias}, block_images {bi}: pieces max err {errs}; "
                f"whole decode equal")


def small_greedy_exactness():
    """K2: the same, against the plain version and the plain ``greedy``,
    single theta and an S=3 bank with one out-of-range style row."""
    s = SMALL
    for seed, bias in SMALL_SEEDS + SMALL_EXIT_SEEDS:
        p, raw = small_params(seed, bias)
        dec = dk.GreedyDecoder(p, None, max_len=MAX_LEN, f32=True, device=DEVICE)
        errs = check_greedy_pieces(dec, raw)
        got = dec(raw)
        steps = int(dec.last_steps)
        ref = dec.forward_plain(raw)
        require(int(dec.last_steps) == steps == errs["steps"], f"seed {seed}: steps differ")
        require(torch.equal(got, ref), f"greedy seed {seed}: kernel vs plain differ")
        oracle = greedy(p, raw, max_len=MAX_LEN, device=DEVICE)
        require(torch.equal(got, oracle), f"greedy seed {seed}: kernel vs greedy differ")
        if (seed, bias) in SMALL_EXIT_SEEDS:
            require(steps < MAX_LEN, f"greedy seed {seed}, bias {bias}: no early exit")
        say(f"  greedy seed {seed}, </s> +{bias}: pieces max err {errs}; tokens equal to the "
            f"plain version and to greedy after {steps}/{MAX_LEN} steps; "
            f"row 0 {got[0].tolist()}")
    for seed, bias in SMALL_BANKS:
        p, raw, bank, rows, theta_rows = small_bank(seed, bias)
        oracle = greedy(p, raw, max_len=MAX_LEN, gru_params=theta_rows, device=DEVICE)
        dec = dk.GreedyDecoder(p, bank, max_len=MAX_LEN, f32=True, device=DEVICE)
        errs = check_greedy_pieces(dec, raw, rows)
        got = dec(raw, rows)
        require(torch.equal(got, dec.forward_plain(raw, rows)), "greedy bank: kernel vs plain")
        require(torch.equal(got, oracle), "greedy bank: kernel vs per-row-theta greedy")
        say(f"  greedy S=3 bank {seed}, </s> +{bias} (row 7 clamped to 2): pieces max err "
            f"{errs}; tokens equal to the plain version and to per-row-theta greedy")


# ------------------------------------------------------------------ 4, 5
def full_model():
    g = gen(0)
    decoder = attention_gru_init(g, NF, FO, E, H, V, device=DEVICE)
    hn = hypernet_init(g, hyper_emb=E, input_dim=E + FO, hidden_dim=H, device=DEVICE)
    n_hn = sum(t.numel() for head in [hn["base"], *hn["heads"].values()]
               for layer in head.values() for t in layer.values())
    decoder["fc"]["b"][2] += EOS_BIAS
    model = {"decoder": decoder, "hn": hn}
    theta = synthesize_theta(model, 4)
    n_theta = sum(t.numel() for t in theta.values())
    require(n_theta == theta_param_count(E + FO, H) == 361200, f"theta has {n_theta}")
    say(f"  hypernet {n_hn} parameters; theta {n_theta} numbers")
    cg = torch.Generator(device=DEVICE).manual_seed(1)
    batches = [torch.randn((B, R, NF), generator=cg, device=DEVICE) for _ in range(N_BATCHES)]
    return model, theta, batches


def serve(server, items):
    return [unpack_beam_result(out) for out in server.map(items)]


def agreement(got, ref, what: str, enforce: bool) -> float:
    """Share of images whose tokens, found and length are equal and whose
    score is within FULL_SCORE_TOL; prints every mismatch."""
    ok = 0
    n = 0
    for g, r in zip(got, ref):
        r = [x.cpu().numpy() for x in r]
        for i in range(g[0].shape[0]):
            n += 1
            same = (np.array_equal(g[0][i], r[0][i]) and g[2][i] == r[2][i]
                    and g[3][i] == r[3][i])
            margin = float(g[1][i] - r[1][i])
            if same and (not g[2][i] or abs(margin) <= FULL_SCORE_TOL):
                ok += 1
            elif enforce:
                say(f"  {what} mismatch image {i}: score margin {margin:.3e}, "
                    f"lengths {g[3][i]}/{r[3][i]}, found {g[2][i]}/{r[2][i]}")
    rate = ok / n
    say(f"  {what}: {ok}/{n} images agree ({rate:.4f}) [{CARD}]")
    if enforce:
        require(rate >= FULL_AGREEMENT, f"{what}: agreement {rate} < {FULL_AGREEMENT}")
    return rate


def check_outputs(results, what: str, min_found: float = 0.5, min_long: float = 0.0) -> None:
    found = np.concatenate([r.found for r in results])
    for r in results:
        require(r.tokens.shape == (B, MAX_STEPS + 1), f"{what}: tokens {r.tokens.shape}")
        require(np.isfinite(r.scores[r.found]).all(), f"{what}: non-finite scores")
        require((r.lengths[r.found] >= 2).all(), f"{what}: bad lengths")
    require(found.mean() >= min_found, f"{what}: only {found.mean()} of images completed")
    lengths = np.concatenate([r.lengths for r in results])[found]
    long_share = (lengths > 2).sum() / found.size
    say(f"  {what}: {found.mean():.4f} of images completed, {long_share:.4f} past step 1, "
        f"lengths {lengths.min()}..{lengths.max()} (mean {lengths.mean():.2f})")
    require(long_share >= min_long, f"{what}: only {long_share} of images completed past step 1")


def count_launches(run, what: str, kernels=dk.BEAM_KERNELS):
    """Drive one path with every kernel's count set to 0 just before it and
    read just after it; each kernel of the path must have launched on it."""
    for op in dk.KERNELS:
        op.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = {op.name: op.launches for op in kernels}
    say(f"  {what} launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the {what} path")
    return out, launches


def mid_copy(dec_params, bias: float = MID_BIAS):
    """The decoder with +bias on </s> in place of +EOS_BIAS."""
    mid = dict(dec_params, fc={"w": dec_params["fc"]["w"], "b": dec_params["fc"]["b"].clone()})
    mid["fc"]["b"][2] += bias - EOS_BIAS
    return mid


def main_path(model, theta, batches):
    dec_params = model["decoder"]
    servers = {
        "f32": make_beam_server(dec_params, theta, max_steps=MAX_STEPS, packed=True, f32=True,
                                device=DEVICE),
        "bf16": make_beam_server(dec_params, theta, max_steps=MAX_STEPS, packed=True,
                                 device=DEVICE),
    }
    served, launches = count_launches(
        lambda: {k: serve(s, batches) for k, s in servers.items()}, "main-path")
    for k, res in served.items():
        check_outputs(res, f"served {k}")
    plain = {
        k: dk.BeamDecoder(dec_params, theta, max_steps=MAX_STEPS, f32=(k == "f32"), device=DEVICE)
        for k in servers
    }
    ref = {k: [plain[k].forward_plain(f) for f in batches] for k in servers}
    agreement(served["f32"], ref["f32"], "f32 kernel vs plain", enforce=True)
    agreement(served["bf16"], ref["bf16"], "bf16 kernel vs plain", enforce=False)
    agreement(served["bf16"], ref["f32"], "bf16 kernel vs f32 plain", enforce=False)
    dec_mid = dk.BeamDecoder(mid_copy(dec_params), theta, max_steps=MAX_STEPS, f32=True,
                             device=DEVICE)
    got = [unpack_beam_result(fetch(pack_beam_result(dec_mid(f)))) for f in batches]
    check_outputs(got, f"f32, </s> bias +{MID_BIAS}", min_found=0.05, min_long=MIN_LONG)
    agreement(got, [dec_mid.forward_plain(f) for f in batches],
              f"f32 kernel vs plain, </s> bias +{MID_BIAS}", enforce=True)
    return launches, servers["bf16"]


def biased(model):
    """The decoder at +EOS_BIAS and its copy at +MID_BIAS on </s>."""
    return {f"+{EOS_BIAS}": model["decoder"], f"+{MID_BIAS}": mid_copy(model["decoder"])}


def style_bank(model):
    """An S=3 theta bank (styles 4, 3, 6), one style row per image with row
    5 out of range (7, clamped to style 2), and the same rows with 2 there."""
    ids = torch.tensor([4, 3, 6], device=DEVICE)
    bank = synthesize_theta_batched(model, style_table(model)[ids])
    rows = np.random.RandomState(0).randint(0, 3, B).astype(np.int32)
    rows[5] = 7
    rows2 = rows.copy()
    rows2[5] = 2
    return bank, rows, rows2


def mixed_styles(model, batches):
    """The S=3 bank path: f32 at +1.2 and at +MID_BIAS on </s>, and bf16 at
    +1.2, each with one out-of-range style row that must decode as the last
    style."""
    bank, rows, rows2 = style_bank(model)
    decs = biased(model)
    servers = {b: make_beam_server(d, bank, max_steps=MAX_STEPS, packed=True, f32=True,
                                   device=DEVICE) for b, d in decs.items()}
    bf16 = make_beam_server(model["decoder"], bank, max_steps=MAX_STEPS, packed=True,
                            device=DEVICE)

    def run():
        got = {b: serve(s, [(f, rows) for f in batches]) for b, s in servers.items()}
        clamped = {b: serve(s, [(batches[0], rows2)])[0] for b, s in servers.items()}
        return got, clamped, serve(bf16, [(f, rows) for f in batches])

    (got, clamped, got_bf16), launches = count_launches(run, "mixed-style")
    refs = {}
    for b, d in decs.items():
        what = f"mixed f32, </s> bias {b}"
        if b == f"+{MID_BIAS}":
            check_outputs(got[b], what, min_found=0.05, min_long=MIN_LONG)
        else:
            check_outputs(got[b], what)
        plain = dk.BeamDecoder(d, bank, max_steps=MAX_STEPS, f32=True, device=DEVICE)
        refs[b] = [plain.forward_plain(f, rows) for f in batches]
        agreement(got[b], refs[b], f"{what}: kernel vs plain", enforce=True)
        c, g = clamped[b], got[b][0]
        require(np.array_equal(c.tokens[5], g.tokens[5]) and c.scores[5] == g.scores[5]
                and c.lengths[5] == g.lengths[5], f"{what}: style row 7 is not clamped to 2")
        say(f"  {what}: style row 7 decodes as style 2 (clamped; length {g.lengths[5]}, "
            f"found {g.found[5]})")
    agreement(got_bf16, refs[f"+{EOS_BIAS}"], "mixed bf16 kernel vs f32 plain", enforce=False)
    return launches


# ------------------------------------------------------------------ 6
def micro_batcher(server, batches, what: str = "micro-batcher", kernels=dk.BEAM_KERNELS):
    n = 32
    feats = batches[0][:n].cpu().numpy()
    direct = fetch(server.decode_fn(feats))
    answers = [None] * n

    def run():
        with MicroBatcher(server.decode_fn, batch_size=n, feature_shape=(R, NF)) as mb:
            def ask(i):
                answers[i] = mb.submit(feats[i]).result(timeout=300)

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            require(not any(th.is_alive() for th in threads), "a request did not finish")

    _, launches = count_launches(run, what, kernels)
    for i in range(n):
        require(np.array_equal(answers[i], direct[i]), f"request {i} differs")
    say(f"  {n} concurrent requests equal their rows of a direct batched call")
    return launches


# ------------------------------------------------------------------ 7 to 10
def greedy_lengths(tokens: np.ndarray):
    """Rows that emitted </s>, and their lengths up to and including it."""
    hit = tokens == END
    ended = hit.any(axis=1)
    return ended, np.where(ended, hit.argmax(axis=1) + 1, 0)


def check_greedy_outputs(results, what: str) -> None:
    toks = np.concatenate(results)
    require(toks.shape == (B * len(results), MAX_LEN), f"{what}: tokens {toks.shape}")
    require(toks.dtype == np.int32 and (toks >= 0).all() and (toks < V).all(),
            f"{what}: tokens out of range")
    ended, length = greedy_lengths(toks)
    after = (np.arange(MAX_LEN)[None, :] >= length[:, None]) & ended[:, None]
    require((toks[after] == 0).all(), f"{what}: a token after </s> is not <pad>")
    lens = length[ended]
    span = f"lengths {lens.min()}..{lens.max()} (mean {lens.mean():.2f})" if lens.size else ""
    say(f"  {what}: {ended.mean():.4f} of rows end within {MAX_LEN} steps, {span}")


def greedy_agreement(got, ref, what: str, enforce: bool) -> float:
    """Share of rows whose tokens are identical."""
    g, r = np.concatenate(got), np.concatenate(ref)
    same = (g == r).all(axis=1)
    rate = float(same.mean())
    say(f"  {what}: {int(same.sum())}/{same.size} rows agree ({rate:.4f}) [{CARD}]")
    if enforce:
        for i in np.flatnonzero(~same)[:10]:
            say(f"  {what} mismatch row {i}: {g[i].tolist()} vs {r[i].tolist()}")
        require(rate >= FULL_AGREEMENT, f"{what}: agreement {rate} < {FULL_AGREEMENT}")
    return rate


def greedy_servers(model, gru_params):
    return {(b, k): make_greedy_server(d, gru_params, max_len=MAX_LEN, f32=(k == "f32"),
                                       device=DEVICE)
            for b, d in biased(model).items() for k in ("f32", "bf16")}


def greedy_check_against_plain(model, gru_params, served, items) -> None:
    """f32 kernels against the f32 plain version (enforced), bf16 against
    the bf16 and the f32 plain versions (printed), at both biases."""
    for b, d in biased(model).items():
        ref = {}
        for k in ("f32", "bf16"):
            plain = dk.GreedyDecoder(d, gru_params, max_len=MAX_LEN, f32=(k == "f32"),
                                     device=DEVICE)
            ref[k] = [plain.forward_plain(*it).cpu().numpy() for it in items]
        greedy_agreement(served[(b, "f32")], ref["f32"],
                         f"greedy f32 kernel vs plain, </s> {b}", enforce=True)
        greedy_agreement(served[(b, "bf16")], ref["bf16"],
                         f"greedy bf16 kernel vs plain, </s> {b}", enforce=False)
        greedy_agreement(served[(b, "bf16")], ref["f32"],
                         f"greedy bf16 kernel vs f32 plain, </s> {b}", enforce=False)


def greedy_main_path(model, theta, batches):
    """Single style through make_greedy_server: f32 and bf16, at +1.2 and
    +MID_BIAS on </s>."""
    servers = greedy_servers(model, theta)
    served, launches = count_launches(
        lambda: {key: list(s.map(batches)) for key, s in servers.items()},
        "greedy main-path", dk.GREEDY_KERNELS)
    for (b, k), res in served.items():
        check_greedy_outputs(res, f"greedy served {k}, </s> {b}")
    greedy_check_against_plain(model, theta, served, [(f,) for f in batches])
    return launches, servers[(f"+{MID_BIAS}", "bf16")]


def greedy_mixed_styles(model, batches):
    """The S=3 bank through make_greedy_server, f32 and bf16 at both biases,
    with style row 7 that must decode as style 2."""
    bank, rows, rows2 = style_bank(model)
    servers = greedy_servers(model, bank)
    items = [(f, rows) for f in batches]

    def run():
        got = {key: list(s.map(items)) for key, s in servers.items()}
        clamped = {key: list(s.map([(batches[0], rows2)]))[0] for key, s in servers.items()
                   if key[1] == "f32"}
        return got, clamped

    (got, clamped), launches = count_launches(run, "greedy mixed-style", dk.GREEDY_KERNELS)
    for (b, k), res in got.items():
        check_greedy_outputs(res, f"greedy mixed {k}, </s> {b}")
    greedy_check_against_plain(model, bank, got, items)
    for (b, k), c in clamped.items():
        require(np.array_equal(c[5], got[(b, k)][0][5]),
                f"greedy mixed {b}: style row 7 is not clamped to 2")
        say(f"  greedy mixed f32, </s> {b}: style row 7 decodes as style 2 (clamped)")
    return launches


def steps_run(model, theta, batches):
    """Steps the decoders actually run on one batch, with the early exit:
    at +1.2 on </s> both must stop before their last step.  Then, for the
    first benchmark's choice of a bias that gives realistic caption lengths,
    the steps, the share of captions that end and their lengths at other
    biases (bf16, single style)."""
    for b, d in biased(model).items():
        for k in ("f32", "bf16"):
            beam = dk.BeamDecoder(d, theta, max_steps=MAX_STEPS, f32=(k == "f32"), device=DEVICE)
            beam(batches[0])
            grd = dk.GreedyDecoder(d, theta, max_len=MAX_LEN, f32=(k == "f32"), device=DEVICE)
            grd(batches[0])
            steps = (int(beam.last_steps), int(grd.last_steps))
            say(f"  </s> {b}, {k}: beam ran {steps[0]}/{MAX_STEPS} steps, greedy "
                f"{steps[1]}/{MAX_LEN} (B={B})")
            if b == f"+{EOS_BIAS}":
                require(steps[0] < MAX_STEPS, f"beam at {b} ({k}) did not exit early")
                require(steps[1] < MAX_LEN, f"greedy at {b} ({k}) did not exit early")
    for bias in SWEEP_BIASES:
        d = mid_copy(model["decoder"], bias)
        beam = dk.BeamDecoder(d, theta, max_steps=MAX_STEPS, device=DEVICE)
        res = fetch(beam(batches[0]))
        grd = dk.GreedyDecoder(d, theta, max_len=MAX_LEN, device=DEVICE)
        ended, length = greedy_lengths(fetch(grd(batches[0])))
        found = res.found
        blen = res.lengths[found]
        say(f"  </s> +{bias}, bf16: beam {int(beam.last_steps)}/{MAX_STEPS} steps, "
            f"{found.mean():.4f} complete, mean length {blen.mean() if blen.size else 0:.2f} "
            f"(incl. the start token); greedy {int(grd.last_steps)}/{MAX_LEN} steps, "
            f"{ended.mean():.4f} end, mean length "
            f"{length[ended].mean() if ended.any() else 0:.2f} (B={B})")


# ------------------------------------------------------------------ 11
def device_ms(fn, iters: int) -> float:
    """Device time per call: the card sleeps while the host queues the
    calls, so the events measure the kernels back to back."""
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


def wall_ms(fn, iters: int) -> float:
    """Per-call time of a function that may wait on the host (plain versions)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_entry(name, op, kind, source, replaces, fn, plain, lib, n_bytes, flops, err,
                 wdt, paths, per_batch):
    """Time one kernel, its plain version and its library yardstick, and
    give its line of the ``kernels`` record."""
    ms = device_ms(fn, 50)
    plain_ms = wall_ms(plain, 5)
    lib_ms = device_ms(lib, 20) if lib is not None else None
    bms, by = bound_ms(n_bytes, flops, wdt)
    launches = {path: counts[op.name] for path, counts in paths[kind].items()}
    say(f"  {name}: {ms:.4f} ms/launch, {launches['main'] // per_batch} launches per "
        f"batch, bound {bms:.4f} ms by {by}, plain {plain_ms:.4f} ms, library "
        f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}, max abs err {err:.3e} "
        f"(B={B}, bf16 weights) [{CARD}]")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches["main"], "launches_mixed": launches["mixed"],
        "launches_micro": launches["micro"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
    }


def cell_cost(feats, att1, h, tok, styles, w, h_new):
    """Bytes and operations of one cell step over ``h``'s rows."""
    rows = h.shape[0]
    S, In, G = w["wih_t"].shape
    n_bytes = (nbytes(feats, att1, h, tok, styles, w["ua_w"], w["ua_b"], w["va"],
                      w["wih_t"], w["whh_t"], w["bih"], w["bhh"], h_new)
               + rows * E * w["emb"].element_size())
    return n_bytes, 2 * rows * (H * H + 2 * R * H + R * FO + In * G + H * G)


BEAM_SOURCE = "captionax_torch/ops/csrc/beam_decode.cu"
GREEDY_SOURCE = "captionax_torch/ops/csrc/greedy_decode.cu"
BEAM_TPU = "captionax/ops/decode_kernel.py:555"
GREEDY_TPU = "captionax/ops/decode_kernel.py:329"


def beam_times(model, theta, batches, paths):
    """K1's kernels at step 1 of a full-width batch (bf16 weights).  The
    exit flags are set open, so every timed launch does its whole work."""
    dec = dk.BeamDecoder(model["decoder"], theta, max_steps=MAX_STEPS, device=DEVICE)
    feats, att1, h0, styles = dec.prepare(batches[0], None)
    w = dec.weights()
    wdt = w["fc_w"].dtype
    state = dk._init_state(h0, MAX_STEPS)
    h1 = dk.cell_step(feats, att1, state["h"], state["tok"], styles, 0, w)
    dk.beam_select(*dk.logits_top3_partial(h1, w["fc_w"], w["fc_b"]), h1, state, 0, END)
    state["hist_in"], state["hist_out"] = state["hist_out"], state["hist_in"]
    state["run"].fill_(1)
    t = 1  # a step with real embeddings and three live beams per image
    rows = B * dk.K
    vp = w["fc_w"].shape[1]
    C = vp // dk.CHUNK
    T = MAX_STEPS + 1
    per_batch = N_BATCHES * 2  # the main path serves each batch at f32 and bf16
    out = []

    cell = lambda: dk.cell_step(feats, att1, state["h"], state["tok"], styles, t, w)
    cell_plain = lambda: dk.cell_step_plain(feats, att1, state["h"], state["tok"], styles, t, w)
    hk, hp = cell(), cell_plain()
    out.append(kernel_entry(
        "cell_step (beam rows)", dk.CELL, "beam", BEAM_SOURCE, BEAM_TPU, cell, cell_plain,
        None, *cell_cost(feats, att1, state["h"], state["tok"], styles, w, hk),
        (hk - hp).abs().max().item(), wdt, paths, per_batch))

    logits = lambda: dk.logits_top3_partial(hp, w["fc_w"], w["fc_b"])
    logits_plain = lambda: dk.logits_top3_partial_plain(hp, w["fc_w"], w["fc_b"])
    h_lib = hp.to(wdt)

    def logits_library():
        x = (torch.matmul(h_lib, w["fc_w"]).float() + w["fc_b"]).reshape(rows, C, dk.CHUNK)
        return torch.topk(x, 3, dim=2), torch.logsumexp(x, dim=2)

    pk, pp = logits(), logits_plain()
    idx_diff = (pk[1] != pp[1]).any(dim=2).float().mean().item()
    say(f"  (b) full width: share of (row, chunk) top-3 index lists that differ "
        f"kernel vs plain: {idx_diff:.2e}")
    out.append(kernel_entry(
        "logits_top3_partial", dk.LOGITS, "beam", BEAM_SOURCE, BEAM_TPU, logits, logits_plain,
        logits_library, nbytes(hp, w["fc_w"], w["fc_b"], *pk), 2 * rows * H * vp,
        (pk[0] - pp[0]).abs().max().item(), wdt, paths, per_batch))

    base = clone_state(state)
    sk, sp = clone_state(base), clone_state(base)
    dk.beam_select(*pp, hp, sk, t, END)
    dk.beam_select_plain(*pp, hp, sp, t, END)
    improved = int((sk["best_len"] != base["best_len"]).sum().item())
    sel_bytes = (nbytes(*pp, hp, sk["h"], sk["hist_in"], sk["hist_out"])
                 + 2 * nbytes(sk["tok"], sk["score"])
                 + nbytes(sk["best_val"], sk["best_len"], sk["found"])
                 + improved * T * 4)
    scratch = clone_state(base)
    select = lambda: dk.beam_select(*pp, hp, scratch, t, END)
    scratch_plain = clone_state(base)
    select_plain = lambda: dk.beam_select_plain(*pp, hp, scratch_plain, t, END)
    out.append(kernel_entry(
        "beam_select", dk.SELECT, "beam", BEAM_SOURCE, BEAM_TPU, select, select_plain, None,
        sel_bytes, 0, (sk["score"] - sp["score"]).abs().max().item(), wdt, paths, per_batch))

    # f32 kernels at the same shapes, for the record
    dec32 = dk.BeamDecoder(model["decoder"], theta, max_steps=MAX_STEPS, f32=True,
                           device=DEVICE)
    f32_, a32, _, _ = dec32.prepare(batches[0], None)
    w32 = dec32.weights()
    c32 = device_ms(lambda: dk.cell_step(f32_, a32, state["h"], state["tok"], styles, t,
                                         w32), 50)
    l32 = device_ms(lambda: dk.logits_top3_partial(hp, w32["fc_w"], w32["fc_b"]), 50)
    say(f"  f32 weights: cell_step (beam rows) {c32:.4f} ms, logits_top3_partial "
        f"{l32:.4f} ms (B={B}) [{CARD}]")
    return out


def greedy_times(model, theta, batches, paths):
    """K2's kernels at step 1 of a full-width batch (bf16 weights, the
    decoder at +MID_BIAS on </s>, so that most rows are still live), with
    the exit flags open; (a) also at every instantiated row tile."""
    dec = dk.GreedyDecoder(mid_copy(model["decoder"]), theta, max_len=MAX_LEN, device=DEVICE)
    feats, att1, h0, styles = dec.prepare(batches[0], None)
    w = dec.weights()
    wdt = w["fc_w"].dtype
    state = dk._init_greedy_state(h0, MAX_LEN)
    cell_at = lambda br: functools.partial(dk.cell_step, zero_word_t0=False, block_rows=br)
    h1 = cell_at(dk.GREEDY_BLOCK_ROWS)(feats, att1, state["h"], state["tok"], styles, 0, w)
    dk.greedy_select(*dk.logits_top1_partial(h1, w["fc_w"], w["fc_b"]), h1, state, 0, END)
    state["run"].fill_(1)
    t = 1
    rows = B
    vp = w["fc_w"].shape[1]
    C = vp // dk.CHUNK
    per_batch = N_BATCHES * 4  # f32 and bf16 at two biases
    out = []

    args = (feats, att1, state["h"], state["tok"], styles, t, w)
    cell = lambda: cell_at(dk.GREEDY_BLOCK_ROWS)(*args)
    cell_plain = lambda: dk.cell_step_plain(*args, zero_word_t0=False)
    hk, hp = cell(), cell_plain()
    for br in dk.TILE_ROWS:  # the tiles that greedy does not use are held too
        err = (cell_at(br)(*args) - hp).abs().max().item()
        require(err <= FULL_SCORE_TOL, f"(a) greedy rows, {br} rows per block: {err}")
    tiles = {br: device_ms(lambda br=br: cell_at(br)(*args), 50) for br in dk.TILE_ROWS}
    say("  cell_step (greedy rows) by rows per block: "
        + ", ".join(f"{br}: {ms:.4f} ms" for br, ms in tiles.items()) + f" (B={B}) [{CARD}]")
    out.append(kernel_entry(
        "cell_step (greedy rows)", dk.CELL, "greedy", BEAM_SOURCE, GREEDY_TPU, cell,
        cell_plain, None, *cell_cost(*args[:5], w, hk), (hk - hp).abs().max().item(), wdt,
        paths, per_batch))

    logits = lambda: dk.logits_top1_partial(hp, w["fc_w"], w["fc_b"])
    logits_plain = lambda: dk.logits_top1_partial_plain(hp, w["fc_w"], w["fc_b"])
    h_lib = hp.to(wdt)

    def logits_library():
        x = torch.matmul(h_lib, w["fc_w"]).float() + w["fc_b"]
        return x.reshape(rows, C, dk.CHUNK).max(dim=2)

    pk, pp = logits(), logits_plain()
    say(f"  (b1) full width: share of (row, chunk) argmaxes that differ kernel vs plain: "
        f"{(pk[1] != pp[1]).float().mean().item():.2e}")
    out.append(kernel_entry(
        "logits_top1_partial", dk.LOGITS1, "greedy", GREEDY_SOURCE, GREEDY_TPU, logits,
        logits_plain, logits_library, nbytes(hp, w["fc_w"], w["fc_b"], *pk),
        2 * rows * H * vp, (pk[0] - pp[0]).abs().max().item(), wdt, paths, per_batch))

    base = clone_state(state)
    sk, sp = clone_state(base), clone_state(base)
    dk.greedy_select(*pp, hp, sk, t, END)
    dk.greedy_select_plain(*pp, hp, sp, t, END)
    for k in sk:
        require(torch.equal(sk[k], sp[k]), f"(c1) full width: {k} differs from the plain version")
    # the timed launches repeat step t on a state that its first launch has
    # updated: rows still live after it copy h and write their token
    live = int((sk["done"] == 0).sum().item())
    sel_bytes = nbytes(*pp) + live * (2 * H * 4 + 4) + rows * 4 * 3
    scratch = clone_state(base)
    select = lambda: dk.greedy_select(*pp, hp, scratch, t, END)
    scratch_plain = clone_state(base)
    select_plain = lambda: dk.greedy_select_plain(*pp, hp, scratch_plain, t, END)
    out.append(kernel_entry(
        "greedy_select", dk.GREEDY_SELECT, "greedy", GREEDY_SOURCE, GREEDY_TPU, select,
        select_plain, None, sel_bytes, 0, (sk["h"] - sp["h"]).abs().max().item(), wdt, paths,
        per_batch))
    say(f"  (c1) full width: state equal to the plain version; {live}/{rows} rows live "
        f"after step {t}")
    return out


def bare_launch_ms(op, call) -> float:
    """Host time of the ctypes call alone that ``call`` makes through ``op``:
    the wrapper's checks, views and output allocations left out."""
    seen = []
    op.launch = lambda symbol, *args: seen.append((symbol, args))
    try:
        keep = call()  # the outputs whose addresses the recorded call holds
    finally:
        del op.launch
    symbol, args = seen[0]
    fn = getattr(_cuda.library(), symbol)
    ms = wall_ms(lambda: fn(*args), 200)
    del keep
    return ms


def skipped_step_cost(model, theta, batches):
    """Host time of each wrapper when its step's exit flag is 0: the kernels
    return at entry, so this is what a step after the exit costs; and of the
    bare ctypes launches within it."""
    out = {}
    for kind, decoder in (
        ("beam", dk.BeamDecoder(model["decoder"], theta, max_steps=MAX_STEPS, device=DEVICE)),
        ("greedy", dk.GreedyDecoder(model["decoder"], theta, max_len=MAX_LEN, device=DEVICE)),
    ):
        feats, att1, h0, styles = decoder.prepare(batches[0], None)
        w = decoder.weights()
        if kind == "beam":
            state = dk._init_state(h0, MAX_STEPS)
            cell = functools.partial(dk.cell_step, block_rows=dk.K * decoder.block_images)
            logits, select = dk.logits_top3_partial, dk.beam_select
        else:
            state = dk._init_greedy_state(h0, MAX_LEN)
            cell = functools.partial(dk.cell_step, zero_word_t0=False,
                                     block_rows=dk.GREEDY_BLOCK_ROWS)
            logits, select = dk.logits_top1_partial, dk.greedy_select
        state["run"].zero_()
        live = state["run"][1:]
        h_new = cell(feats, att1, state["h"], state["tok"], styles, 1, w, live=live)
        parts = logits(h_new, w["fc_w"], w["fc_b"], live=live)
        calls = {
            "a": (dk.CELL, lambda: cell(feats, att1, state["h"], state["tok"], styles, 1, w,
                                        live=live)),
            "b": (dk.LOGITS if kind == "beam" else dk.LOGITS1,
                  lambda: logits(h_new, w["fc_w"], w["fc_b"], live=live)),
            "c": (dk.SELECT if kind == "beam" else dk.GREEDY_SELECT,
                  lambda: select(*parts, h_new, state, 1, END)),
        }
        times = {k: wall_ms(call, 200) for k, (_, call) in calls.items()}
        bare = {k: bare_launch_ms(op, call) for k, (op, call) in calls.items()}
        out[kind] = sum(times.values())
        say(f"  a skipped {kind} step: {out[kind] * 1e3:.1f} us on the host ("
            + ", ".join(f"({k}) {v * 1e3:.1f} us" for k, v in times.items())
            + f"; kernels return at entry), of which the bare ctypes launches "
            f"{sum(bare.values()) * 1e3:.1f} us ("
            + ", ".join(f"({k}) {v * 1e3:.1f} us" for k, v in bare.items())
            + f"); the rest is the wrappers' checks, views and allocations [{CARD}]")
    return out


def kernel_busy_ms(fn) -> float:
    """The card's kernel and copy time during one call of ``fn``, from a
    torch.profiler trace; 0.0 when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def decode_host_time(model, theta, batches):
    """One bf16 decode of a full-width batch in the served loop's decoder, at
    both </s> biases: the host time to issue it (no sync inside), its wall
    time to the end of its last kernel, and the share of that wall time in
    which the card ran kernels (a profiler trace of one more call)."""
    for b, d in biased(model).items():
        for kind, decoder, steps in (
            ("beam", dk.BeamDecoder(d, theta, max_steps=MAX_STEPS, device=DEVICE), MAX_STEPS),
            ("greedy", dk.GreedyDecoder(d, theta, max_len=MAX_LEN, device=DEVICE), MAX_LEN),
        ):
            decoder(batches[0])
            torch.cuda.synchronize()
            issue, wall = [], []
            for x in batches * 2:
                t0 = time.perf_counter()
                decoder(x)
                issue.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
            issue_ms, decode_ms = np.median(issue) * 1e3, np.median(wall) * 1e3
            run = int(decoder.last_steps)
            try:
                busy = kernel_busy_ms(lambda: decoder(batches[0]))
                share = (f"card busy {busy:.3f} ms, {busy / decode_ms:.1%} of the wall time"
                         if busy > 0 else "card busy time not measured (no device time traced)")
            except Exception as exc:  # a measurement, not a check
                share = f"card busy time not measured ({type(exc).__name__}: {exc})"
            say(f"  {kind} decode, </s> {b}, {run}/{steps} steps run: host issues it in "
                f"{issue_ms:.3f} ms ({issue_ms / steps * 1e3:.1f} us per issued step), wall "
                f"{decode_ms:.3f} ms (medians of {len(issue)}); {share} [{CARD}]")


def served_rates(model, theta, batches):
    """Captions per second through the bf16 beam and greedy servers at both
    </s> biases (host clock over 6 batches, after one warm-up batch; three
    repeats, each printed, since the host's share varies between them)."""
    items = batches * 2
    for b, d in biased(model).items():
        servers = {
            "beam": make_beam_server(d, theta, max_steps=MAX_STEPS, packed=True, device=DEVICE),
            "greedy": make_greedy_server(d, theta, max_len=MAX_LEN, device=DEVICE),
        }
        for kind, server in servers.items():
            list(server.map(batches[:1]))
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = list(server.map(items))
                dt = time.perf_counter() - t0
                require(len(outs) == len(items), "server dropped a batch")
                rates.append(len(items) * B / dt)
            steps = f"{MAX_STEPS} steps, k=3" if kind == "beam" else f"max_len {MAX_LEN}"
            say(f"  served bf16 {kind}, </s> {b}: "
                + ", ".join(f"{r:.1f}" for r in rates) + " captions/s ("
                + ", ".join(f"{B / r * 1e3:.2f}" for r in rates)
                + f" ms per batch of {B}; {steps}) [{CARD}]")


# ------------------------------------------------------------------ 12-15: training
T_CAP = 25            # caption length of a training batch (benchmarks/trainstep_roofline.py)
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
STYLE = 4             # 'factual'
# (B, T, R, F, E, H): an odd batch (a partial row tile), one row, 49 regions
SMALL_TRAIN = ((5, 7, 9, 24, 24, 24), (1, 4, 5, 16, 16, 16), (13, 6, 49, 40, 24, 32))
# the CPU tests' tolerances (tests/test_torch_train_kernel.py): the forward
# rtol = atol = 1e-5; a gradient rtol 2e-4, atol max(2e-5 * its scale, 1e-6)
FWD_RTOL = FWD_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SCALE, GRAD_ATOL_FLOOR = 2e-4, 2e-5, 1e-6
# bf16 kernel vs the bf16 plain version, relative to the largest entry: sums
# in other orders flip bf16 roundings, which 25 steps carry along
BF16_REL_BOUND = 5e-2
# f32 losses of the K3 route against the per-step loop: after step 1 the
# parameters differ by Adam's normalisation of float-noise gradients
TRAIN_LOSS_RTOL = 1e-3
TRAIN_SOURCE = "captionax_torch/ops/csrc/train_recurrence.cu"
K3_FWD_TPU = "captionax/ops/train_kernel.py:76"
K3_BWD_TPU = "captionax/ops/train_kernel.py:101"
GRAD_NAMES = ("feats", "att1", "h0", "embeds", "ua_w", "ua_b", "va", "wih_t", "whh_t",
              "bih", "bhh")
ROW_NAMES = ("x", "dgi", "hp", "dghn", "datt2")


def close_or_fail(got, ref, what, rtol, atol) -> float:
    """Max abs error of got vs ref; fail where |got - ref| > atol + rtol |ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} entries off, max err "
            f"{err.max().item():.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return err.max().item()


def grad_close(got, ref, what) -> float:
    scale = max(ref.float().abs().max().item(), 1e-3)
    return close_or_fail(got, ref, what, GRAD_RTOL, max(GRAD_ATOL_SCALE * scale, GRAD_ATOL_FLOOR))


def random_core(b, t, r, f, e, h, cdt, seed):
    """The eleven inputs of the recurrence at a small shape, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rnd = lambda *shape, sc=1.0: torch.randn(shape, generator=g, device=DEVICE) * sc
    n_in = e + f
    return (rnd(b, r, f).to(cdt), rnd(b, r, h).to(cdt), rnd(b, h, sc=0.5), rnd(b, t, e),
            rnd(h, h, sc=h ** -0.5).to(cdt), rnd(h, sc=0.1), rnd(h, sc=h ** -0.5),
            rnd(n_in, 3 * h, sc=n_in ** -0.5).to(cdt), rnd(h, 3 * h, sc=h ** -0.5).to(cdt),
            rnd(3 * h, sc=0.1), rnd(3 * h, sc=0.1))


def check_k3(args, g, what: str, enforce: bool) -> dict:
    """Every K3 kernel against its plain version on the same inputs: the
    forward's hs; pass 1's per-row gradients, pass-2 rows and d(v_a); pass
    2a on pass 1's rows; pass 2b on pass 2a's partials; and the eleven
    gradients of the whole backward.  f32 (enforce) is held to the CPU
    tests' tolerances; otherwise each relative error is printed and held to
    BF16_REL_BOUND.  -> max abs error per kernel."""
    rel = {}

    def cmp(got, ref, name, grad=True):
        if enforce:
            return (grad_close(got, ref, f"{what} {name}") if grad else
                    close_or_fail(got, ref, f"{what} {name}", FWD_RTOL, FWD_ATOL))
        err = (got.float() - ref.float()).abs().max().item()
        rel[name] = err / max(ref.float().abs().max().item(), 1e-12)
        require(rel[name] <= BF16_REL_BOUND, f"{what} {name}: relative error {rel[name]:.3e}")
        return err

    hp = tk.fused_fwd_plain(*args)
    errs = {"train_fwd": cmp(tk.fused_fwd(*args), hp, "hs", grad=False)}
    pp = tk.bwd_recurrence_plain(*args, hp, g)
    pk = tk.bwd_recurrence(*args, hp, g)
    e1 = [cmp(pk[i], pp[i], n) for i, n in enumerate(("d_feats", "d_att1", "d_h0", "d_emb"))]
    e1 += [cmp(pk[4][k], pp[4][k], f"row {k}") for k in ROW_NAMES]
    e1.append(cmp(pk[5].sum(dim=0), pp[5][0], "d_va (sum of the blocks)"))
    errs["train_bwd_recurrence"] = max(e1)
    part_k = tk.wgrad_partial(pk[4])
    part_p = tk.wgrad_partial_plain(pk[4])
    errs["train_wgrad_partial"] = cmp(part_k, part_p, "weight-gradient partials")
    out_k, dva_k = tk.wgrad_reduce(part_k, pk[5])
    out_p, dva_p = tk.wgrad_reduce_plain(part_k, pk[5])
    errs["train_wgrad_reduce"] = max(cmp(out_k, out_p, "reduced weight gradients"),
                                     cmp(dva_k, dva_p, "reduced d_va"))
    gk = tk.fused_bwd(*args, hp, g)
    gp = tk.fused_bwd_plain(*args, hp, g)
    whole = max(cmp(a, b, f"d_{n}") for n, a, b in zip(GRAD_NAMES, gk, gp))
    if not enforce:
        say(f"  {what}: relative error per output (bf16 bound {BF16_REL_BOUND}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    errs["whole backward"] = whole
    return errs


def train_small_exactness():
    """K3 at small shapes in f32, with an odd batch (a partial row tile)
    and a batch of one row; and d(v_a bias) = 0 through the autograd
    Function on the card."""
    for i, shape in enumerate(SMALL_TRAIN):
        b, t = shape[:2]
        args = random_core(*shape, torch.float32, 40 + i)
        g = torch.randn((b, t, shape[-1]), generator=torch.Generator(device=DEVICE)
                        .manual_seed(50 + i), device=DEVICE)
        errs = check_k3(args, g, f"small {shape}", True)
        say(f"  small (B, T, R, F, E, H) = {shape}, f32: max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    s = SMALL
    p = attention_gru_init(gen(3), s["NF"], s["F"], s["E"], s["H"], s["V"], device=DEVICE)
    raw = torch.randn((5, s["R"], s["NF"]), generator=torch.Generator(device=DEVICE)
                      .manual_seed(4), device=DEVICE)
    caps = torch.randint(1, s["V"], (5, 7), generator=torch.Generator(device=DEVICE)
                         .manual_seed(5), device=DEVICE)
    reset_k3()
    loss, grads = tsteps._value_and_grad(
        lambda q: tk.fused_teacher_forced_hidden(q, raw, caps)[0].square().sum(), p)
    require(tk.BWD.launches == 1, "the backward did not run through K3")
    require(not bool(grads["attention"]["v_a"]["b"].any()), "d(v_a bias) is not 0")
    require(bool(grads["attention"]["U_a"]["b"].any()), "d(U_a bias) is 0")
    say("  d(v_a bias) through the autograd Function: exactly 0")


def train_batch(batches):
    caps = torch.randint(1, V, (B, T_CAP), generator=torch.Generator(device=DEVICE)
                         .manual_seed(7), device=DEVICE)
    return {"features": batches[0], "captions": caps,
            "style_id": torch.tensor(STYLE, device=DEVICE)}


def train_core(model, batch, cdt):
    """The recurrence's inputs at full width, as the train step builds them
    (bf16 copies of the parameters under bf16 compute)."""
    params = {"decoder": model["decoder"], "hn": model["hn"]}
    if cdt == torch.bfloat16:
        params = tsteps._bf16(params)
    with torch.no_grad():
        theta = synthesize_theta(params, STYLE)
        return tk.core_inputs(params["decoder"], batch["features"].to(cdt), batch["captions"],
                              theta)


def train_full_width(model, batch):
    """K3 against its plain versions at full width, B=1024, T=25: f32 held
    to the CPU tests' tolerances, bf16 printed and bounded."""
    out = {}
    for cdt, enforce in ((torch.float32, True), (torch.bfloat16, False)):
        args = train_core(model, batch, cdt)
        g = torch.randn((B, T_CAP, H), generator=torch.Generator(device=DEVICE).manual_seed(8),
                        device=DEVICE) * 1e-3
        name = "f32" if cdt == torch.float32 else "bf16"
        out[name] = check_k3(args, g, f"full width {name}", enforce)
        say(f"  full width B={B}, T={T_CAP}, {name} compute: max abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in out[name].items()) + f" [{CARD}]")
    return out


def step_breakdown(train, state, batch, what: str) -> None:
    """Where one train step's card time goes: a torch.profiler trace of one
    step, the kernels' device time summed by name (the top ten) and the
    card-busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        say(f"  {what}: card time not measured (no device time traced)")
        return
    k3 = sum(r[0] for r in rows if "train_" in r[2])
    gemm = sum(r[0] for r in rows if "gemm" in r[2].lower() and "train_" not in r[2])
    say(f"  {what}: card busy {busy:.2f} ms of a {wall:.2f} ms traced step "
        f"({busy / wall:.1%}): K3 kernels {k3:.2f} ms, library matrix products "
        f"{gemm:.2f} ms, other kernels (elementwise, reductions, copies) "
        f"{busy - k3 - gemm:.2f} ms; top kernels by device time [{CARD}]:")
    for ms, n, key in rows[:10]:
        say(f"    {ms:9.3f} ms  {n:5d} x  {key[:110]}")


def step_phases(state, batch, tx, bf16: bool, fused: bool, what: str) -> None:
    """Host clock, with a sync after each, of one hypernet train step's
    parts: the loss (hypernet, recurrence and chunked CE forward), its
    backward, and the optimizer update."""
    batch = tsteps._on_params(state.params, batch)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(state.params)]
    params = tree_unflatten(state.params, leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta = hypernet_apply(params["hn"], tsteps.style_token_embed(params, batch))
    loss = tsteps._tf_ce(params["decoder"], batch, 0, gru_params=theta, bf16=bf16, fused=fused)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(leaves, grads)]
    state.apply_gradients(tree_unflatten(state.params, grads), tx)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    say(f"  {what}: loss forward {(t1 - t0) * 1e3:.2f} ms, backward {(t2 - t1) * 1e3:.2f} "
        f"ms, optimizer {(t3 - t2) * 1e3:.2f} ms (host clock, a sync after each) [{CARD}]")


def reset_k3():
    for op in tk.KERNELS:
        op.launches = 0


def train_steps(model, batch):
    """Five hypernet train steps at full width on one batch, style 4, from
    the same init, through K3 (fused_scan=True, the main training path) and
    through the per-step loop, in f32 and bf16 compute over f32 masters;
    then eval_step.  The K3 counts are set to 0 just before the K3 runs and
    read just after."""
    init = {"decoder": model["decoder"], "hn": model["hn"]}
    tx = make_optimizer(TRAIN_LR)
    losses, times, launches, states = {}, {}, {}, {}
    for bf16 in (False, True):
        for fused in (True, False):
            key = ("bf16" if bf16 else "f32", "k3" if fused else "loop")
            train, _ = make_hypernet_steps(tx, bf16=bf16, fused_scan=fused)
            state = create_train_state(init, tx)
            reset_k3()
            ls, ts = [], []
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = train(state, batch)
                ls.append(float(m["train_loss"]))  # a host read: the step has ended
                ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            launches[key] = {op.name: op.launches for op in tk.KERNELS}
            losses[key], times[key], states[key] = ls, ts, state
            ms = float(np.median(ts[1:])) * 1e3
            say(f"  {key[0]} compute, {'K3' if fused else 'per-step loop'}: losses "
                + ", ".join(f"{x:.6f}" for x in ls) + f"; {ms:.2f} ms per step (median of "
                f"steps 2-{TRAIN_STEPS}), {B / ms * 1e3:.1f} images/s; first step "
                f"{ts[0] * 1e3:.1f} ms; K3 launches {launches[key]} [{CARD}]")
    for k3 in (("f32", "k3"), ("bf16", "k3")):
        for name, n in launches[k3].items():
            require(n > 0, f"{name} was not launched on the {k3[0]} K3 training path")
    for loop in (("f32", "loop"), ("bf16", "loop")):
        require(not any(launches[loop].values()), "the per-step loop launched a K3 kernel")
    f32_k3, f32_loop = np.array(losses[("f32", "k3")]), np.array(losses[("f32", "loop")])
    rel = np.abs(f32_k3 - f32_loop) / np.abs(f32_loop)
    say(f"  f32 losses, K3 vs the per-step loop: relative difference per step "
        + ", ".join(f"{x:.2e}" for x in rel) + f" (bound {TRAIN_LOSS_RTOL})")
    require(bool((rel <= TRAIN_LOSS_RTOL).all()), "f32 losses of the two routes differ")
    for key in (("bf16", "k3"), ("bf16", "loop")):
        ls = losses[key]
        require(all(np.isfinite(ls)), f"{key}: a loss is not finite")
        require(ls[-1] < ls[0], f"{key}: the loss did not fall over {TRAIN_STEPS} steps")
    for key, state in states.items():
        require(all(x.dtype == torch.float32 for x in tree_leaves(state.params)),
                f"{key}: a master weight is not f32")
        gru = state.params["decoder"]["gru"]
        require(all(torch.equal(gru[k], init["decoder"]["gru"][k]) for k in gru),
                f"{key}: the decoder's own GRU tensors moved")
    for key in states:
        step_phases(states[key], batch, tx, key[0] == "bf16", key[1] == "k3",
                    f"one {key[0]} {key[1]} train step")
    for key in (("f32", "k3"), ("f32", "loop")):
        try:
            step_breakdown(make_hypernet_steps(tx, fused_scan=key[1] == "k3")[0], states[key],
                           batch, f"one {key[0]} {key[1]} train step")
        except Exception as exc:  # a measurement, not a check
            say(f"  {key}: breakdown not measured ({type(exc).__name__}: {exc})")
    _, evaluate = make_hypernet_steps(tx)
    ev = evaluate(states[("f32", "k3")].params, batch)
    vt, vf = float(ev["val_loss_tf"]), float(ev["val_loss"])
    require(np.isfinite(vt) and np.isfinite(vf), "eval_step losses are not finite")
    require(tuple(ev["logits_tf"].shape) == (B, T_CAP, V), "eval_step logits shape")
    say(f"  eval_step after the f32 K3 steps: val_loss_tf {vt:.6f}, val_loss (free "
        f"running) {vf:.6f}")
    return launches


def k3_cost(args, hs):
    """Bytes and operations of the forward and of pass 1 at these inputs."""
    feats, att1 = args[0], args[1]
    Bn, R_, F_ = feats.shape
    T_ = args[3].shape[1]
    In, H_ = args[7].shape[0], args[2].shape[1]
    G = 3 * H_
    ins = nbytes(*args)
    fwd_flops = 2 * Bn * T_ * (H_ * H_ + R_ * H_ + R_ * F_ + In * G + H_ * G)
    rows = T_ * Bn * (In + G + 3 * H_) * 4
    bwd_flops = fwd_flops + 2 * Bn * T_ * (In * G + H_ * G + 2 * R_ * F_ + 2 * R_ * H_ + H_ * H_)
    bwd_bytes = (ins + 2 * nbytes(hs) + nbytes(feats, att1) + Bn * H_ * 4
                 + Bn * T_ * args[3].shape[2] * 4 + rows)
    return (ins + nbytes(hs), fwd_flops), (bwd_bytes, bwd_flops)


def train_times(model, batch, launches, errs):
    """Per launch (CUDA events), at full width in f32 (the default training
    config) and bf16: each K3 kernel, its plain version and its library
    yardstick, beside its bound.  -> the kernels' entries of the JSON record (f32)."""
    out = []
    steps = TRAIN_STEPS * 2  # the K3 route ran f32 and bf16, five steps each
    main = {op.name: launches[("f32", "k3")][op.name] + launches[("bf16", "k3")][op.name]
            for op in tk.KERNELS}
    for cdt in (torch.float32, torch.bfloat16):
        name = "f32" if cdt == torch.float32 else "bf16"
        args = train_core(model, batch, cdt)
        hs = tk.fused_fwd(*args)
        g = torch.randn((B, T_CAP, H), generator=torch.Generator(device=DEVICE).manual_seed(8),
                        device=DEVICE) * 1e-3
        d_feats, d_att1, d_h0, d_emb, rows, dva_part = tk.bwd_recurrence(*args, hs, g)
        partial = tk.wgrad_partial(rows)
        (fb, ff), (bb, bf) = k3_cost(args, hs)
        ones = lambda a: torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
        x1, hp1 = ones(rows["x"]), ones(rows["hp"])
        dgh = torch.cat([rows["dgi"][:, :2 * H], rows["dghn"]], dim=1)
        lib_wgrad = lambda: (torch.matmul(x1.t(), rows["dgi"]), torch.matmul(hp1.t(), dgh),
                             torch.matmul(hp1.t(), rows["datt2"]))
        lib_reduce = lambda: (torch.sum(partial, dim=0), torch.sum(dva_part, dim=0))
        total = partial.shape[1]
        specs = [
            ("train_fwd", tk.FWD, K3_FWD_TPU, lambda: tk.fused_fwd(*args),
             lambda: tk.fused_fwd_plain(*args), None, fb, ff, cdt),
            ("train_bwd_recurrence", tk.BWD, K3_BWD_TPU, lambda: tk.bwd_recurrence(*args, hs, g),
             lambda: tk.bwd_recurrence_plain(*args, hs, g), None, bb, bf, cdt),
            ("train_wgrad_partial", tk.WGRAD, K3_BWD_TPU, lambda: tk.wgrad_partial(rows),
             lambda: tk.wgrad_partial_plain(rows), lib_wgrad,
             nbytes(*rows.values(), partial),
             2 * T_CAP * B * total, torch.float32),
            ("train_wgrad_reduce", tk.WGRAD_REDUCE, K3_BWD_TPU,
             lambda: tk.wgrad_reduce(partial, dva_part),
             lambda: tk.wgrad_reduce_plain(partial, dva_part), lib_reduce,
             nbytes(partial, dva_part) + (total + H) * 4, partial.numel() + dva_part.numel(),
             torch.float32),
        ]
        for kname, op, tpu, fn, plain, lib, n_bytes, flops, peak_dt in specs:
            iters = 5 if kname in ("train_fwd", "train_bwd_recurrence") else 20
            ms = device_ms(fn, iters)
            plain_ms = wall_ms(plain, 2)
            lib_ms = device_ms(lib, 20) if lib is not None else None
            bms, by = bound_ms(n_bytes, flops, peak_dt)
            say(f"  {kname} ({name} compute): {ms:.4f} ms/launch, "
                f"{main[op.name] // steps} launch per train step, bound {bms:.4f} ms by "
                f"{by}, plain {plain_ms:.4f} ms, library "
                f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}, max abs err "
                f"{errs[name][kname]:.3e} (B={B}, T={T_CAP}) [{CARD}]")
            if cdt == torch.float32:
                out.append({
                    "name": kname, "route": "cuda", "source": TRAIN_SOURCE, "replaces": tpu,
                    "launches": main[op.name], "launches_per_step": main[op.name] // steps,
                    "max_abs_err": errs[name][kname], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                })
    return out


def _out_of_time(signum, frame):
    raise TimeoutError(f"chip_smoke: over its {TIME_LIMIT_S} s limit")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _out_of_time)
    signal.alarm(TIME_LIMIT_S)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with Phase("1 card and build"):
        card_and_build()
    with Phase("2 small-shape exactness, beam"):
        small_exactness()
    with Phase("3 small-shape exactness, greedy"):
        small_greedy_exactness()
    paths = {"beam": {}, "greedy": {}}
    with Phase("4 full width, beam main path"):
        model, theta, batches = full_model()
        paths["beam"]["main"], server = main_path(model, theta, batches)
    with Phase("5 beam, mixed styles"):
        paths["beam"]["mixed"] = mixed_styles(model, batches)
    with Phase("6 beam, micro-batcher"):
        paths["beam"]["micro"] = micro_batcher(server, batches)
    with Phase("7 full width, greedy main path"):
        paths["greedy"]["main"], gserver = greedy_main_path(model, theta, batches)
    with Phase("8 greedy, mixed styles"):
        paths["greedy"]["mixed"] = greedy_mixed_styles(model, batches)
    with Phase("9 greedy, micro-batcher"):
        paths["greedy"]["micro"] = micro_batcher(gserver, batches, "greedy micro-batcher",
                                                 dk.GREEDY_KERNELS)
    with Phase("10 steps actually run"):
        steps_run(model, theta, batches)
    with Phase("11 times"):
        kernels = beam_times(model, theta, batches, paths)
        kernels += greedy_times(model, theta, batches, paths)
        skipped_step_cost(model, theta, batches)
        decode_host_time(model, theta, batches)
        served_rates(model, theta, batches)
    with Phase("12 small-shape exactness, K3"):
        train_small_exactness()
    batch = train_batch(batches)
    with Phase("13 full width, K3 against its plain versions"):
        errs = train_full_width(model, batch)
    with Phase("14 hypernet train steps, K3 and the per-step loop"):
        launches = train_steps(model, batch)
    with Phase("15 times, training"):
        kernels += train_times(model, batch, launches, errs)
    signal.alarm(0)
    say(f"total {time.perf_counter() - t0:.2f} s")
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
