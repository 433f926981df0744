#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``captionax_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the kernels (K1 beam, K2 greedy, K3 the training recurrence, K4
the encoder's bottleneck chains) with nvcc, holds each kernel and
each whole decode against their plain PyTorch versions and against the
plain oracles that run every step (small shapes, then the full width of
the hypernet attention-GRU model), holds the bf16 vocab products of K1 and
K2 (tensor cores, h split into three bf16 terms) against their plain
versions at the edges of their tiling and on ties, holds the select
kernels (a warp per row, merges on ``redux.sync``) against theirs at their
edges (ties, +-0.0, -inf chunks, dead beams, ragged rows), serves batches through
the port's beam and greedy servers, holds the cell step that K1 and K2
share (bf16: its gate products on the tensor cores, [x | h] split into
three bf16 terms) against its plain version at the edges of its tiling,
for beam and greedy rows, one theta and an S=3 bank, shows that the early
exit fires, runs hypernet train steps through K3 and through the per-step
loop (K3's recurrence kernels on thread-block clusters, held to their plain
versions at shapes that cut the cluster tiling, at every cluster size that
fits), holds K4 against its plain version at small shapes and at the full
width of ResNet-152, serves uint8 images through the port's
``CaptionService`` (ResNet-152 on K4, then K1 or K2), and times each
kernel (the cell step's two phases apart, K3's recurrence kernels by
part, the select kernels beside the launch floor), each train step and the
image path.  Phase 20 then drives the training CLIs as a user runs them:
``train_hypernet`` at full width (480 synthetic images, batches of 64, two
epochs, ``--fused-scan`` so the recurrence runs on K3, the frozen
ResNet-152 on K4 behind the card-resident feature cache), checks that K3's
and K4's kernels launched during ``fit`` and that the warm epoch ran no
encoder, that the first step's loss equals the per-step loop's, that
every K3 kernel agrees with its plain version on that step's own inputs,
that the checkpoint and the train state restore exactly, runs ``evaluate``
on the checkpoint against the training run's own beam test, then
``train_gru`` in bf16 through K3 (its step's inputs again through every K3
kernel and its plain version), and prints ms per train step, images/s, the encoder cold
and warm and ``test_beam``'s time.  Phase 21 drives the serving CLIs on
256 written image files (JPEG and PNG, mixed sizes, some gray): ``caption``
(beam over three styles, greedy, ``--requests``; K4, then K1 or K2; every
caption against a direct decode of the same files), ``serve``'s
``build_service`` behind HTTP with 192 concurrent requests, bf16 and
``--int8-encoder`` (each int8 conv's int32 sums against its plain version,
the features within captionax's bounds of the f32 encoder), and the
supervised ``serve`` CLI until two workers have handed over its port
without a client error.  Phase 22 drives the style classifiers and the
style losses on phase 20's corpus: ``train_classifier --kind small`` and
``--kind style3`` at BERT-base width (the BERT probe's probabilities on the
card against the CPU's), then ``train_hypernet --mixup`` on the small
probe (its first step's fed-back words, loss and gradients on the card
against the CPU's on the same draws), ``--style-aux`` on the BERT probe
and ``--mixup --mixup-split`` (read as captionax reads it; the port takes
the same single step): K4 in the cold featurizes, no K3, and each step's time and parts.
Phase 23 drives Conceptual Captions and zero-shot transfer on a seeded CC
corpus (50 domains, 600 captions with an image file each, JPEG and PNG,
some gray; 10 unseen domains): ``cc_train_hypernet --domain-scheme
"histograme log" --fused-scan`` on the files (the gray ones through the
viridis LUT; K3's and K4's kernels in ``fit``, no encoder in the warm
epoch, the first step's loss against the per-step loop's),
``test_zero_shot`` on its checkpoint (two unseen domains' tokens against a
direct decode under their own theta), each of the six domain schemes
built on the card with its first step's loss and gradients against the
same step on the CPU, ``train_hyper_combine --style-aux
--select-sep-margin`` then ``test_all`` (five result sets),
``cc_train_gru``, ``train_cc`` without ``--fetch``, and ``train_init``
then ``train_hypernet --init-hn`` on its checkpoint.  Phase 24 drives
the cell and LSTM captioners on phase 20's corpus after releasing the
earlier phases' card memory: ``train_captioning --cell gru`` at its
defaults (the v0 hypernet captioner, 3.657 B parameters, updated in place
by the chunked optimizer) for an epoch with ``--tf-decay 0.5`` (teacher-
forced and sampled steps; every loss finite, ``fc_out`` bit-equal to its
init, the peak card memory under the card's), ``--cell lstm`` at H=150
(at H=200 it fits no single card), ``capgru_loss``'s first TF and sampled
steps on the card against the CPU (GRU and LSTM, 1 and 2 layers), and
``train_lstm``'s four variants at full width (each first step and greedy
decode against the CPU's, the checkpoint restored exactly).  Phase 25
drives the transformer captioners on phase 20's corpus, on a ResNet-152
with every folded scale drawn: ``train_labert`` at its defaults (106.7 M
parameters) and ``train_catr`` at its defaults (25.8 M) for an epoch with
their validation and decodes (mask-predict, greedy), each CLI's first batch
of features (K4) against ``CNNEncoder.plain``, each step by part, and the
first train step of both models at hidden 64 on the card (f32) against the
CPU (f64) on the CLIs' own first inputs, then both decodes card against
CPU.  Phase 26 runs data parallelism on a mesh of 2 (two cards, else the
one card twice): ``make_sharded_beam_decode`` at B=1024 over the S=3 bank
(K1 on each shard, f32 and bf16) against the unsharded server,
``CaptionService(mesh)`` at B=64 (K4 then K1 or K2 on each shard) over 192
concurrent requests against the one-device service (a batch of 63
raises), the data-parallel K3 step on two ranks (gloo where they share a
card, NCCL where each has its own) with shards of ~4x different token
counts (its first loss and all-reduced gradient against one process on
the whole batch, the replicas bit-equal after every step, one step over a
world-1 NCCL group), and ``train_hypernet --mesh-data 2`` against
``--mesh-data 0`` (the train loss; the validation against one device's on
the same parameters, and its distance from ``--mesh-data 0``'s within 10x
a control's, one device with each batch's rows in another order; one
writer).  Phase 27 runs pipeline, sequence, expert and tensor parallelism
in one process over the card's slots (a card repeats in every slot), and
the checkpoint bridge: (a) LaBERT at ``train_labert``'s defaults over pipe
4 with 8 microbatches and (b) over seq 4, all-gather and ring, each loss
and its gradients against the sequential stack; (c) ``train_labert --pipe
4``, ``--seq 4 --seq-ring`` and ``train_catr --pipe 2`` against ``--pipe
1`` (every step's loss; the first step's gradients in f32, and in f64 on
the same weights and inputs); (d) ``expert_theta_bank`` over 4 slots at
full width against ``synthesize_theta_batched``, then K1 at B=1024 on each
bank; (e) ``scale_check --kind hypernet --mesh-data 2 --mesh-model 2`` and
``--kind labert --pipe 4``; (f) ``export_checkpoint`` of a full-width
``train_hypernet`` checkpoint and its ResNet-152, ``import_checkpoint`` of
the ``.ckpt`` (bit for bit), then ``caption`` (beam over three styles,
greedy; K4 then K1 / K2) from both checkpoints, every row equal.  Phase
28 runs the last four modules: it compiles ``csrc/textenc.cc`` and
``csrc/cider.cc`` afresh (timed) and fails unless both libraries load (no
fallback to Python here), holds the native caption encoder to
``Vocab.encode`` on seeded_corpus's 15,000 captions and the native CIDEr
scorer to the Python one on 3,000 hypotheses (captions/s and seconds of
each), tokenizes a caption with the PTB tokenizer, and runs ``visualize``
on the card at its defaults (ResNet-152 on K4, a seeded 9,684-word vocab)
for the hypernet, ``--kind gru`` and ``--dataset cc``: each report parses
with a row per image and a column per style, and each greedy decode runs
again on the CPU on the card's features.  One line per phase gives the
phase's seconds.
The line before the last is a JSON ``kernels`` record (K3's and K4's
entries also carry their launches in phase 20's ``fit`` and, as
``launches_cc``, in phase 23's ``cc_train_hypernet`` ``fit``; K1's, K2's
and K4's their launches on phase 21's paths, K4's on phase 22's and, as
``launches_cell_lstm``, on phase 24's runs and, as
``launches_transformers``, on phase 25's; K1's, K2's, K3's and K4's, as
``launches_data_parallel``, on phase 26's paths and, as
``launches_parallel``, on phase 27's, and, as ``launches_visualize``, on
phase 28's); the last line is
``{"ok": true, "device": {...}}``.  Any mismatch, a missing card or a
failed build raises, and the script exits non-zero without that last line.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from captionax_torch.cli import caption as cli_caption
from captionax_torch.cli import visualize as cli_visualize
from captionax_torch.cli import cc_train_gru as cli_cc_gru
from captionax_torch.cli import cc_train_hypernet as cli_cc_hypernet
from captionax_torch.cli import train_captioning as cli_captioning
from captionax_torch.cli import train_catr as cli_catr
from captionax_torch.cli import train_classifier as cli_classifier
from captionax_torch.cli import evaluate as cli_evaluate
from captionax_torch.cli import export_checkpoint as cli_export
from captionax_torch.cli import import_checkpoint as cli_import
from captionax_torch.cli import scale_check as cli_scale_check
from captionax_torch.cli import serve as cli_serve
from captionax_torch.cli import test_all as cli_test_all
from captionax_torch.cli import test_zero_shot as cli_zero_shot
from captionax_torch.cli import train_cc as cli_train_cc
from captionax_torch.cli import train_gru as cli_gru
from captionax_torch.cli import train_hyper_combine as cli_combine
from captionax_torch.cli import train_hypernet as cli_hypernet
from captionax_torch.cli import train_init as cli_init
from captionax_torch.cli import train_labert as cli_labert
from captionax_torch.cli import train_lstm as cli_lstm
from captionax_torch.core import native_build, textenc_native
from captionax_torch.core.config import DataConfig, ModelConfig, TrainConfig
from captionax_torch.core.runtime import StepTimer
from captionax_torch.core.vocab import Vocab, load_vocab_pickle
from captionax_torch.data import native_image
from captionax_torch.data.cc import SEP as SEP_CC
from captionax_torch.data.cc import ConceptualCaptionsData, load_cc_captions
from captionax_torch.data.domains import DomainEmbedder
from captionax_torch.data.flickr import load_factual_captions
from captionax_torch.data.seeded_corpus import (
    seeded_cc_corpus,
    seeded_corpus,
    seeded_vocab,
    write_image,
)
from captionax_torch.data.transforms import preprocess_images
from captionax_torch.decode.search import NEG_INF, beam_search, greedy, top_k_first
from captionax_torch.decode.serving import (
    MicroBatcher,
    PipelinedDecoder,
    fetch,
    make_beam_server,
    make_greedy_server,
    make_sharded_beam_decode,
    pack_beam_result,
    unpack_beam_result,
)
from captionax_torch.decode.service import CaptionService, make_http_server
from captionax_torch.decode.supervise import proc_rss_mb
from captionax_torch.eval import PTBTokenizer, cider_native
from captionax_torch.eval.cider import cider_score
from captionax_torch.eval.metrics import ids_to_text
from captionax_torch.interop import from_jax_params, to_device, to_numpy_tree
from captionax_torch.models.classifiers import (
    small_style_classifier_init,
    style_classifier_apply,
    style_classifier_apply_soft,
)
from captionax_torch.models.decoder import attention_gru_init
from captionax_torch.models import encoder as tenc
from captionax_torch.models.encoder import (
    CNNEncoder,
    _first_block,
    from_torch_state_dict,
    resnet_init,
    resnet_stem,
)
from captionax_torch.models.catr import catr_forward, catr_greedy
from captionax_torch.models.cell_decoders import gumbel_noise
from captionax_torch.models.hypernet import hypernet_apply, hypernet_init, theta_param_count
from captionax_torch.models import convert
from captionax_torch.models.labert import labert_loss, length_bucket, mask_predict_decode
from captionax_torch.models.layers import count_params
from captionax_torch.ops import _cuda
from captionax_torch.ops import conv_kernel as ck
from captionax_torch.ops import decode_kernel as dk
from captionax_torch.ops import train_kernel as tk
from captionax_torch.ops.probe import select_times as sel_probe
from captionax_torch.parallel import make_mesh, replicate_params, shard_batch
from captionax_torch.parallel import launch as dp_launch
from captionax_torch.parallel.mesh import (
    Mesh,
    backend_for,
    data_parallel,
    default_devices,
    reduce_gradients,
    reduce_metrics,
    shard_bounds,
)
from captionax_torch.parallel.pipeline import (
    pipeline_mesh,
    pipelined_bert_encoder,
    pipelined_catr_stacks,
)
from captionax_torch.parallel.sequence import (
    expert_theta_bank,
    sequence_mesh,
    sequence_parallel_bert_encoder,
)
from captionax_torch.train import checkpoint as tckpt
from captionax_torch.train import harness
from captionax_torch.train import steps as tsteps
from captionax_torch.train.losses import cross_entropy_loss
from captionax_torch.train.state import (
    create_train_state,
    make_optimizer,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from captionax_torch.train.steps import (
    make_hypernet_steps,
    resolve_style_id,
    style_table,
    synthesize_theta,
    synthesize_theta_batched,
)

TIME_LIMIT_S = 1100
ROOT = os.path.dirname(os.path.abspath(__file__))
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
FULL_INDEX_SHARE = 1e-3  # (row, chunk) index lists of a bf16 vocab kernel that may differ at full width
# the bf16 vocab products (tensor cores, h split into three bf16 terms): the
# shapes of their edge sweep, and their kernels' names in ptxas's report
VOCAB_EDGE_ROWS = (1, 3, 63, 64, 65, 127, 129, 192, 1024, 3072)
VOCAB_EDGE_H = (24, 200, 256)  # 256: the widest h, on the 8-stage ring
VOCAB_EDGE_VP = (128, 384, 9728)
VOCAB_KERNELS = ("logits_top3_wgmma_kernel", "logits_top1_wgmma_kernel")
# the bf16 cell step (a): its edge sweep's row counts, and its kernels' names
CELL_EDGE_ROWS = (1, 3, 63, 64, 65, 192, 1024, 3072)
CELL_KERNELS = ("attend_kernel", "gates_kernel")

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
def ptxas_report(log: str, name: str) -> dict:
    """{entry: (registers, spill-store bytes, spill-load bytes)} of every
    kernel whose mangled name holds ``name`` (each template instance), from
    nvcc's ``-Xptxas -v`` output."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m[1] if name in m[1] else None
            if entry:
                out[entry] = [None, None, None]
        elif entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[entry][1:] = [int(m[1]), int(m[2])]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[entry][0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


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
        if any(k in line for k in ("registers", "spill", "smem", "Compiling entry", "wgmma")):
            say("  ptxas:", line.strip())
    if info.log:
        for name in VOCAB_KERNELS + CELL_KERNELS:
            report = ptxas_report(info.log, name)
            require(len(report) > 0, f"ptxas reports no kernel {name}")
            for entry, (regs, stores, loads) in report.items():
                say(f"  {entry}: {regs} registers, {stores} B spill stores, {loads} B spill loads")
                require(regs is not None and stores == 0 and loads == 0,
                        f"{entry}: ptxas reports spills")
        for entry, (regs, stores, loads) in ptxas_report(info.log, "rec").items():
            if any(k in entry for k in K3_KERNELS):
                say(f"  K3 {entry}: {regs} registers, {stores} B spill stores, {loads} B spill "
                    "loads")
        fold = ptxas_report(info.log, "train_feats_fold_kernel")
        require(len(fold) == 2 * tk.FOLD_REGIONS, f"ptxas reports {len(fold)} fold instances")
        for entry, (regs, stores, loads) in fold.items():
            require(regs is not None and stores == 0 and loads == 0,
                    f"{entry}: ptxas reports spills")
    else:
        say("  the library was already built: no ptxas report to check")
    lib = _cuda.library()
    for (bwd, name), per_c in k3_shapes(R, FO, E, H).items():
        say(f"  K3 {'train_bwd_recurrence' if bwd else 'train_fwd'} {name} at full width: "
            "dynamic shared memory and clusters the card runs at once, by CTAs a cluster: "
            + ", ".join(f"C={c}: {sm} B, {n}" for c, (sm, n) in per_c.items())
            + f"; at B={B} the rule takes C="
            + str(tk.cluster_shape(B, {c: n for c, (_, n) in per_c.items()})[0]))
    say("  dynamic shared memory: train_wgrad_partial "
        f"{lib.train_wgrad_smem()} B; conv_gemm_bf16 at tile width "
        + ", ".join(f"{bn}: {lib.conv_stage_bf16_smem(bn)} B" for bn in ck.TILE_WIDTHS)
        + "; bf16 logits_top3_partial / logits_top1_partial at depth "
        + ", ".join(f"{hd}: {lib.vocab_product_smem(hd)} B" for hd in VOCAB_EDGE_H)
        + f"; bf16 cell_step at H={H}: attention phase at rows per block "
        + ", ".join(f"{br}: {lib.cell_attend_smem(br, H, R, E + FO)} B" for br in dk.TILE_ROWS)
        + ", gate phase at (rows, groups) a block "
        + ", ".join(f"{t}: {lib.cell_gates_smem(*t, E + FO, H)} B" for t in dk.GATE_TILES))


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
    # bf16 weights: (b) on the tensor cores, h split into three bf16 terms
    for seed, bias in SMALL_SEEDS + SMALL_EXIT_SEEDS:
        p, raw = small_params(seed, bias)
        dec = dk.BeamDecoder(p, None, max_steps=s["steps"], block_images=4, device=DEVICE)
        errs = check_pieces(dec, raw)
        compare_results(dec(raw), dec.forward_plain(raw), SMALL_SCORE_TOL, f"bf16 seed {seed}")
        say(f"  bf16 weights, seed {seed}, </s> +{bias}: pieces max err {errs}; whole decode "
            f"equal to the plain version")
    for seed, bias in SMALL_BANKS:
        p, raw, bank, rows, _ = small_bank(seed, bias)
        dec = dk.BeamDecoder(p, bank, max_steps=s["steps"], block_images=4, device=DEVICE)
        errs = check_pieces(dec, raw, rows)
        compare_results(dec(raw, rows), dec.forward_plain(raw, rows), SMALL_SCORE_TOL,
                        f"bf16 bank {seed}")
        say(f"  bf16 weights, S=3 bank {seed}, </s> +{bias}: pieces max err {errs}; whole "
            f"decode equal")


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
    # bf16 weights: (b1) on the tensor cores, h split into three bf16 terms
    for seed, bias in SMALL_SEEDS + SMALL_EXIT_SEEDS:
        p, raw = small_params(seed, bias)
        dec = dk.GreedyDecoder(p, None, max_len=MAX_LEN, device=DEVICE)
        errs = check_greedy_pieces(dec, raw)
        require(torch.equal(dec(raw), dec.forward_plain(raw)), f"bf16 greedy seed {seed}")
        say(f"  bf16 weights, greedy seed {seed}, </s> +{bias}: pieces max err {errs}; tokens "
            f"equal to the plain version")
    for seed, bias in SMALL_BANKS:
        p, raw, bank, rows, _ = small_bank(seed, bias)
        dec = dk.GreedyDecoder(p, bank, max_len=MAX_LEN, device=DEVICE)
        errs = check_greedy_pieces(dec, raw, rows)
        require(torch.equal(dec(raw, rows), dec.forward_plain(raw, rows)), f"bf16 greedy bank {seed}")
        say(f"  bf16 weights, greedy S=3 bank {seed}, </s> +{bias}: pieces max err {errs}; "
            f"tokens equal")


# ------------------------------------------------------------------ 3b
def exact_operands(rows: int, hd: int, vp: int, seed: int):
    """h [rows, hd], fc_w [hd, vp] bf16 and fc_b [vp] whose logits are exact
    in f32 in any order of the sums: each row of h has min(16, hd) nonzero
    entries s1 2^-e + s2 2^-(e+9) + s3 2^-(e+18) (signs s, e in {1, 2}: most
    split into three nonzero bf16 terms), fc_w is in {-1, 0, 1} and fc_b a
    multiple of 2^-20 in (-2, 2), so every partial sum is a multiple of
    2^-20 below 16 in magnitude: 24 bits.  Equal logits tie bit for bit."""
    g = gen(seed)
    k = min(16, hd)
    pos = torch.rand((rows, hd), generator=g).argsort(dim=1)[:, :k]
    e = torch.randint(1, 3, (rows, k), generator=g)
    one = torch.ones((rows, k), dtype=torch.int64)

    def sign():
        return torch.randint(0, 2, (rows, k), generator=g) * 2 - 1

    units = sign() * (one << (20 - e)) + sign() * (one << (11 - e)) + sign() * (one << (2 - e))
    h = torch.zeros((rows, hd)).scatter_(1, pos, units.float() * 2.0 ** -20)
    w = torch.randint(-1, 2, (hd, vp), generator=g).to(torch.bfloat16)
    b = torch.randint(-2 ** 21 + 1, 2 ** 21, (vp,), generator=g).float() * 2.0 ** -20
    return h.to(DEVICE), w.to(DEVICE), b.to(DEVICE)


def random_operands(rows: int, hd: int, vp: int, seed: int):
    """h = tanh(normal) (a GRU state: every f32 bit in use), fc_w = bf16 of
    0.1 * normal, fc_b = 0.5 * normal."""
    g = gen(seed)
    h = torch.tanh(torch.randn((rows, hd), generator=g))
    w = (torch.randn((hd, vp), generator=g) * 0.1).to(torch.bfloat16)
    b = torch.randn((vp,), generator=g) * 0.5
    return h.to(DEVICE), w.to(DEVICE), b.to(DEVICE)


def lo_share(h) -> float:
    """Share of h's nonzero entries whose third bf16 term is nonzero."""
    r = h - h.to(torch.bfloat16).float()
    lo = (r - r.to(torch.bfloat16).float()).to(torch.bfloat16)
    return ((lo != 0).sum() / (h != 0).sum()).item()


def vocab_compare(h, w, b, equal_indices: bool, equal_values: bool = False) -> dict:
    """Both bf16 vocab kernels against their plain versions on one input:
    values within SMALL_SCORE_TOL (the sums of exp relative to themselves);
    the indices equal, or else at most FULL_INDEX_SHARE of the (row, chunk)
    index lists differing; with ``equal_values`` (exact operands) the
    maxima and top-3 values equal too."""
    pk, pp = dk.logits_top3_partial(h, w, b), dk.logits_top3_partial_plain(h, w, b)
    qk, qp = dk.logits_top1_partial(h, w, b), dk.logits_top1_partial_plain(h, w, b)
    torch.cuda.synchronize()
    out = {
        "err": max((pk[0] - pp[0]).abs().max().item(), (pk[2] - pp[2]).abs().max().item(),
                   (qk[0] - qp[0]).abs().max().item()),
        "sum_rel": ((pk[3] - pp[3]).abs() / pp[3]).max().item(),
        "top3_differ": (pk[1] != pp[1]).any(dim=2).float().mean().item(),
        "top1_differ": (qk[1] != qp[1]).float().mean().item(),
    }
    what = f"rows {h.shape[0]}, H {h.shape[1]}, Vp {w.shape[1]}"
    require(out["err"] <= SMALL_SCORE_TOL and out["sum_rel"] <= SMALL_SCORE_TOL,
            f"bf16 vocab kernels, {what}: {out}")
    if equal_indices:
        require(torch.equal(pk[1], pp[1]) and torch.equal(qk[1], qp[1]),
                f"bf16 vocab kernels, {what}: indices differ: {out}")
    else:
        require(max(out["top3_differ"], out["top1_differ"]) <= FULL_INDEX_SHARE,
                f"bf16 vocab kernels, {what}: index lists differ: {out}")
    if equal_values:
        require(torch.equal(pk[0], pp[0]) and torch.equal(pk[2], pp[2])
                and torch.equal(qk[0], qp[0]),
                f"bf16 vocab kernels, {what}, exact logits: values differ: {out}")
    return out


def vocab_edges() -> None:
    """The bf16 (b) and (b1) against their plain versions at every row count,
    depth and padded vocab of the edge sweep, on exact and on random
    operands; then ties: several zero fc_w columns with one fc_b, within a
    chunk and across chunks, which tie bit for bit."""
    worst = {"exact": {}, "random": {}}
    shares = []
    for i, (rows, hd, vp) in enumerate((r, hd, vp) for r in VOCAB_EDGE_ROWS
                                       for hd in VOCAB_EDGE_H for vp in VOCAB_EDGE_VP):
        for kind, make in (("exact", exact_operands), ("random", random_operands)):
            ops = make(rows, hd, vp, 1000 + i)
            exact = kind == "exact"
            if exact:
                shares.append(lo_share(ops[0]))
            got = vocab_compare(*ops, equal_indices=exact, equal_values=exact)
            for k, v in got.items():
                worst[kind][k] = max(worst[kind].get(k, 0.0), v)
    say(f"  edge sweep, {len(VOCAB_EDGE_ROWS) * len(VOCAB_EDGE_H) * len(VOCAB_EDGE_VP)} shapes "
        f"(rows {VOCAB_EDGE_ROWS}, H {VOCAB_EDGE_H}, Vp {VOCAB_EDGE_VP}): exact operands "
        f"(h's third bf16 term nonzero in {min(shares):.3f}-{max(shares):.3f} of its entries): "
        f"indices and logits equal, worst {worst['exact']}; random operands: worst "
        f"{worst['random']}")
    tied = (5, 17, 64, 100, 130, 300)  # four in chunk 0, one in chunks 1 and 2
    for kind, make in (("exact", exact_operands), ("random", random_operands)):
        for rows, vp in ((3, 384), (129, 384), (64, 9728)):
            if kind == "random" and vp > 384:
                continue  # exact-index checks of random logits only where lists are few
            h, w, b = make(rows, 200, vp, 77 + rows)
            cols = list(tied) + [vp - 1]
            w[:, cols] = 0
            b[cols] = 20.0 if kind == "random" else 15.0
            got = vocab_compare(h, w, b, equal_indices=True, equal_values=kind == "exact")
            pk = dk.logits_top3_partial(h, w, b)
            qk = dk.logits_top1_partial(h, w, b)
            require(bool((pk[1][:, 0] == torch.tensor(tied[:3], device=DEVICE)).all())
                    and bool((qk[1][:, :3] == torch.tensor([5, 130, 300], device=DEVICE)).all()),
                    f"ties ({kind}, rows {rows}, Vp {vp}): not the first occurrences")
            say(f"  ties ({kind} operands, rows {rows}, H 200, Vp {vp}, columns {cols} at one "
                f"bias): first occurrences, indices equal to the plain version; {got}")


# ------------------------------------------------------------------ 3c
# The select kernels' edge shapes, (images, vocab chunks C, H, T): images
# not a multiple of the images a block; C % 4 != 0, so that rows of
# partials start off a 16-byte boundary (a scalar head and tail); H % 4 != 0
# (h copied as words); C > 256 (pm and ps read past a lane's first round);
# and the decode's own C = 76, H = 200, T = 51 (last).  Greedy takes 3 rows
# an image of these, not a multiple of its 4 or 8 rows a block.
SELECT_EDGE = ((5, 76, 200, 51), (7, 3, 36, 9), (9, 5, 37, 12), (3, 77, 30, 51), (1, 1, 4, 4),
               (2, 301, 40, 9), (64, 76, 200, 51))
SELECT_CASES = ("random", "ties", "zeros", "neginf", "dead", "last wins")


def edge_logits(rows: int, C: int, case: str, g) -> torch.Tensor:
    """Logits [rows, C * 128] of one edge case: "ties" holds few distinct
    values (equal values across chunks and across a warp's lanes); "zeros"
    has its largest values +0.0 and -0.0, one value to the reference."""
    n = C * dk.CHUNK
    x = torch.randn((rows, n), generator=g)
    if case == "ties":
        x = torch.round(x * 2) / 2
    elif case == "zeros":
        x = -x.abs() - 0.5
        pos = torch.randint(0, n, (rows, 6), generator=g)
        x.scatter_(1, pos[:, :3], 0.0)
        x.scatter_(1, pos[:, 3:], -0.0)
    return x


def edge_partials(x: torch.Tensor, top: int, neginf: bool, g):
    """The partials (b) or (b1) leaves for logits x, as their plain versions
    compute them; with ``neginf`` about a third of the chunks hold -inf
    (indices the chunk's first columns; max -inf, sum of exp 1), never all
    of a row's."""
    rows, n = x.shape
    C = n // dk.CHUNK
    xc = x.reshape(rows * C, dk.CHUNK)
    v, i = top_k_first(xc, top)
    v = v.reshape(rows, C, top)
    idx = (i.reshape(rows, C, top) + (torch.arange(C) * dk.CHUNK)[None, :, None]).int()
    m = xc.max(dim=1).values.reshape(rows, C)
    s = torch.exp(xc - m.reshape(-1, 1)).sum(dim=1).reshape(rows, C)
    if neginf and C > 1:
        dead = torch.rand((rows, C), generator=g) < 1 / 3
        dead[:, torch.randint(0, C, (1,), generator=g)] = False
        v[dead] = -torch.inf
        idx[dead] = ((torch.arange(C) * dk.CHUNK)[None, :, None]
                     + torch.arange(top)[None, None, :]).int().expand(rows, C, top)[dead]
        m[dead] = -torch.inf
        s[dead] = 1.0
    if top == 1:
        return v[:, :, 0].contiguous(), idx[:, :, 0].contiguous()
    return v, idx, m, s


def edge_beam_inputs(n_img: int, C: int, hd: int, T: int, case: str, g, device=None):
    """(partials, h_new, state, t) of one beam edge case, on ``device`` (the
    card by default)."""
    rows = n_img * dk.K
    x = edge_logits(rows, C, case, g)
    score = torch.randn((rows,), generator=g) * 2
    best_val = torch.where(torch.rand((n_img,), generator=g) < 0.5,
                           torch.full((n_img,), NEG_INF), torch.randn((n_img,), generator=g) * 3)
    if case == "ties":  # even images: beam 1 a copy of beam 0, equal scores
        for i in range(0, n_img, 2):
            x[3 * i + 1] = x[3 * i]
            score[3 * i + 1] = score[3 * i]
            x[3 * i, END] = x[3 * i].max() + 1  # both end: a tie between two completions
            x[3 * i + 1, END] = x[3 * i, END]
    if case == "dead":  # per image: all live, beam 0 alone (as at t=0), one live, none
        pattern = torch.tensor([[1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 0]])
        live = pattern[torch.arange(n_img) % 4].reshape(-1).bool()
        score = torch.where(live, score, torch.full_like(score, NEG_INF))
    if case == "last wins":  # beam 0's top-3 ends with </s>: the third candidate completes
        x[0::3] = x[0::3].clamp(max=2.0)
        x[0::3, 5], x[0::3, 9], x[0::3, END] = 5.0, 4.0, 3.0
        score[1::3] = score[2::3] = NEG_INF
        best_val.fill_(NEG_INF)
    parts = edge_partials(x, 3, case == "neginf", g)
    t = int(torch.randint(0, T - 1, (1,), generator=g))
    run = torch.zeros((T,), dtype=torch.int32)
    run[t] = 1
    state = {
        "h": torch.randn((rows, hd), generator=g),
        "tok": torch.randint(0, C * dk.CHUNK, (rows,), generator=g, dtype=torch.int32),
        "score": score,
        "hist_in": torch.randint(0, 50, (rows, T), generator=g, dtype=torch.int32),
        "hist_out": torch.randint(0, 50, (rows, T), generator=g, dtype=torch.int32),
        "best_seq": torch.randint(0, 50, (n_img, T), generator=g, dtype=torch.int32),
        "best_val": best_val,
        "best_len": torch.randint(0, T, (n_img,), generator=g, dtype=torch.int32),
        "found": torch.randint(0, 2, (n_img,), generator=g, dtype=torch.int32),
        "run": run,
    }
    h_new = torch.randn((rows, hd), generator=g)
    dev = device or DEVICE
    return ([p.to(dev) for p in parts], h_new.to(dev), {k: v.to(dev) for k, v in state.items()},
            t)


def edge_greedy_inputs(rows: int, C: int, hd: int, max_len: int, case: str, g, device=None):
    """(partials, h_new, state, t) of one greedy edge case, on ``device`` (the
    card by default); a third of the rows have </s> as their first argmax, a
    third are done already."""
    x = edge_logits(rows, C, case, g)
    x[0::3, END] = x[0::3].max(dim=1).values + (0.0 if case == "ties" else 1.0)
    parts = edge_partials(x, 1, case == "neginf", g)
    t = int(torch.randint(0, max_len, (1,), generator=g))
    run = torch.zeros((max_len + 1,), dtype=torch.int32)
    run[t] = 1
    state = {
        "h": torch.randn((rows, hd), generator=g),
        "tok": torch.randint(0, C * dk.CHUNK, (rows,), generator=g, dtype=torch.int32),
        "done": (torch.rand((rows,), generator=g) < 1 / 3).int(),
        "out": torch.randint(0, 50, (rows, max_len), generator=g, dtype=torch.int32),
        "run": run,
    }
    h_new = torch.randn((rows, hd), generator=g)
    dev = device or DEVICE
    return ([p.to(dev) for p in parts], h_new.to(dev), {k: v.to(dev) for k, v in state.items()},
            t)


@contextlib.contextmanager
def forced_select(images=None, warps=None, pdl=None):
    """Within: (c) takes ``images`` images a block, (c1) ``warps`` warps a
    block and programmatic dependent launch as ``pdl`` says, in place of
    ``select_images_per_block``, ``greedy_select_warps`` and
    GREEDY_SELECT_PDL (None: the choice stays)."""
    chosen = dk.select_images_per_block, dk.greedy_select_warps, dk.GREEDY_SELECT_PDL
    if images is not None:
        dk.select_images_per_block = lambda n_img, sms: images
    if warps is not None:
        dk.greedy_select_warps = lambda rows, sms: warps
    if pdl is not None:
        dk.GREEDY_SELECT_PDL = pdl
    try:
        yield
    finally:
        dk.select_images_per_block, dk.greedy_select_warps, dk.GREEDY_SELECT_PDL = chosen


def select_edges() -> None:
    """(c) and (c1) against their plain versions at every edge shape and
    case, at every images-per-block of (c) and every warps-per-block of
    (c1), with and without its programmatic dependent launch: ints equal,
    floats within SMALL_SCORE_TOL; a closed gate leaves the state as it
    was."""
    g = gen(123)
    n = 0
    for (n_img, C, hd, T), case in ((s, c) for s in SELECT_EDGE for c in SELECT_CASES):
        parts, h_new, state, t = edge_beam_inputs(n_img, C, hd, T, case, g)
        ref = clone_state(state)
        dk.beam_select_plain(*parts, h_new, ref, t, END)
        for images in dk.SELECT_IMAGES:
            got = clone_state(state)
            with forced_select(images=images):
                dk.beam_select(*parts, h_new, got, t, END)
            compare_states(ref, got, f"(c) {case}, images {n_img}, C {C}, H {hd}, T {T}, "
                                     f"{images} a block")
            n += 1
        rows = n_img * dk.K
        gparts, gh, gstate, gt = edge_greedy_inputs(rows, C, hd, MAX_LEN, case, g)
        gref = clone_state(gstate)
        dk.greedy_select_plain(*gparts, gh, gref, gt, END)
        for warps, pdl in ((w, p) for w in dk.GREEDY_SELECT_WARPS for p in (False, True)):
            got = clone_state(gstate)
            with forced_select(warps=warps, pdl=pdl):
                dk.greedy_select(*gparts, gh, got, gt, END)
            for k in gref:
                require(torch.equal(gref[k], got[k]), f"(c1) {case}, rows {rows}, C {C}, H {hd}: "
                        f"{k} differs at {warps} warps a block, pdl {pdl}")
            n += 1
        if case == "random":  # a closed gate: nothing changes
            for st, call in ((state, lambda s_: dk.beam_select(*parts, h_new, s_, t, END)),
                             (gstate, lambda s_: dk.greedy_select(*gparts, gh, s_, gt, END))):
                got = clone_state(st)
                got["run"].zero_()
                before = clone_state(got)
                call(got)
                compare_states(before, got, f"closed gate, images {n_img}, C {C}")
    torch.cuda.synchronize()
    say(f"  {n} select launches at {len(SELECT_EDGE)} shapes (images, C, H, T) {SELECT_EDGE} x "
        f"cases {SELECT_CASES}: every state equal to the plain version's (ints exactly, floats "
        f"within {SMALL_SCORE_TOL}); a closed gate changes nothing")


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
    for op in dk.KERNELS + ck.KERNELS:
        op.launches = 0
    ck.LAUNCHES_BY_WIDTH.clear()
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


# ------------------------------------------------------------------ 4b
def cell_edges(model, theta, batches) -> None:
    """(a) against its plain version at full width at every row count of
    CELL_EDGE_ROWS, for beam rows (3 an image: the counts that are whole
    images) and greedy rows; one theta, and an S=3 bank with the styles
    clustered, interleaved and out of range; t = 0 and 1 (the zero word, or
    token 0's embedding for greedy, then real tokens); f32 and bf16
    weights; rows per block of (a) cycling through TILE_ROWS.  Each within
    SMALL_SCORE_TOL, the tolerance of the per-step pieces checks."""
    bank = synthesize_theta_batched(model, style_table(model)[torch.tensor([4, 3, 6],
                                                                          device=DEVICE)])
    g = gen(40)
    raw = torch.cat(batches)  # 3072 images: the greedy rows' largest count
    worst, n = {}, 0
    for f32 in (True, False):
        decs = {S: dk.BeamDecoder(model["decoder"], gru, f32=f32, device=DEVICE)
                for S, gru in ((1, theta), (3, bank))}
        for kind, rpi in (("beam", dk.K), ("greedy", 1)):
            for rows in CELL_EDGE_ROWS:
                if rows % rpi:
                    continue
                b = rows // rpi
                h = torch.tanh(torch.randn((rows, H), generator=g)).to(DEVICE)
                tok = torch.randint(0, V, (rows,), generator=g, dtype=torch.int32).to(DEVICE)
                layouts = {"one theta": (1, torch.zeros(b, dtype=torch.int32)),
                           "clustered": (3, torch.arange(b, dtype=torch.int32) * 3 // b),
                           "interleaved": (3, torch.arange(b, dtype=torch.int32) % 3),
                           "out of range": (3, torch.randint(-2, 6, (b,), generator=g,
                                                             dtype=torch.int32))}
                prepared = {S: d.prepare(raw[:b], torch.zeros(b, dtype=torch.int32))
                            for S, d in decs.items()}
                for layout, (S, styles) in layouts.items():
                    feats, att1, _, _ = prepared[S]
                    w, st = decs[S].weights(), styles.to(DEVICE)
                    for t in (0, 1):
                        br = dk.TILE_ROWS[n % len(dk.TILE_ROWS)]
                        n += 1
                        got = dk.cell_step(feats, att1, h, tok, st, t, w,
                                           zero_word_t0=kind == "beam", block_rows=br)
                        ref = dk.cell_step_plain(feats, att1, h, tok, st, t, w,
                                                 zero_word_t0=kind == "beam")
                        err = (got - ref).abs().max().item()
                        what = (f"(a) {'f32' if f32 else 'bf16'} {kind} rows {rows}, {layout}, "
                                f"t {t}, {br} rows per block")
                        require(err <= SMALL_SCORE_TOL, f"{what}: max abs err {err}")
                        key = ("f32" if f32 else "bf16", kind)
                        worst[key] = max(worst.get(key, 0.0), err)
    say(f"  cell_step edge sweep, {n} cases (rows {CELL_EDGE_ROWS}; beam rows where whole "
        f"images; one theta and an S=3 bank clustered, interleaved, out of range; t 0 and 1): "
        "max abs err against the plain version "
        + ", ".join(f"{k[0]} {k[1]} {v:.3e}" for k, v in worst.items()) + f" [{CARD}]")


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
                 wdt, paths, per_batch, lib_bf16=None):
    """Time one kernel, its plain version and its library yardstick (and,
    for the vocab products, the library call on bf16(h), another function),
    and give its line of the ``kernels`` record."""
    ms = device_ms(fn, 50)
    plain_ms = wall_ms(plain, 5)
    lib_ms = device_ms(lib, 20) if lib is not None else None
    bms, by = bound_ms(n_bytes, flops, wdt)
    launches = {path: counts[op.name] for path, counts in paths[kind].items()}
    extra = {}
    if lib_bf16 is not None:
        extra["library_bf16_ms"] = device_ms(lib_bf16, 20)
    say(f"  {name}: {ms:.4f} ms/launch, {launches['main'] // per_batch} launches per "
        f"batch, bound {bms:.4f} ms by {by}, plain {plain_ms:.4f} ms, library "
        f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}"
        + (f" (on bf16(h): {extra['library_bf16_ms']:.4f} ms)" if extra else "")
        + f", max abs err {err:.3e} (B={B}, bf16 weights) [{CARD}]")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches["main"], "launches_mixed": launches["mixed"],
        "launches_micro": launches["micro"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, **extra,
    }


def check_full_width(pk, pp, what: str) -> float:
    """A bf16 vocab kernel's partials against the plain version's at full
    width: at most FULL_INDEX_SHARE of the (row, chunk) index lists differ,
    the values (and the beam's sums of exp, relative) within FULL_SCORE_TOL.
    -> the share of differing lists."""
    idx = pk[1] != pp[1]
    share = (idx.any(dim=2) if idx.dim() == 3 else idx).float().mean().item()
    err = max((k - p).abs().max().item() for k, p in zip(pk[::2], pp[::2]))
    rel = ((pk[3] - pp[3]).abs() / pp[3]).max().item() if len(pk) == 4 else 0.0
    say(f"  {what} full width: share of (row, chunk) index lists that differ kernel vs "
        f"plain {share:.2e}, max abs err of values {err:.3e}, of sums of exp (relative) "
        f"{rel:.3e} [{CARD}]")
    require(share <= FULL_INDEX_SHARE, f"{what}: {share} of index lists differ")
    require(err <= FULL_SCORE_TOL and rel <= FULL_SCORE_TOL, f"{what}: values differ")
    return share


def depth16_ms(fn, h, w) -> float:
    """A vocab kernel's time on the first 16 depths of h and fc_w: the same
    rows, chunks, copies and epilogues with 1/13 of H=200's products."""
    h16, w16 = h[:, :16].contiguous(), w[:16].contiguous()
    return device_ms(lambda: fn(h16, w16), 50)


CELL_PARTS = {"attention": 1, "without U_a": 1 | 4, "without the scores": 1 | 8,
              "without the context": 1 | 16, "gates": 2, "without the copy of [x | h]": 2 | 32}


def cell_phases_ms(call) -> dict:
    """Device times of the bf16 cell's attention phase and gate phase, each
    launched alone (the C entry's ``phases`` 1 and 2) with the arguments
    that ``call`` gives it, and of each phase with one part left out
    (CELL_PARTS; a part's cost is the phase's time less that)."""
    seen = []
    dk.CELL.launch = lambda symbol, *args: seen.append((symbol, args))
    try:
        keep = call()  # h_new, whose address the recorded call holds
    finally:
        del dk.CELL.launch
    symbol, args = seen[0]
    require(symbol == "cell_step_bf16", f"{symbol} has no phases")
    rows, F_, E_, H_, mb = args[16], args[20], args[21], args[22], args[25]
    apk = torch.empty((-(-rows // mb) * mb, 3, (-(-(E_ + F_) // 16) + -(-H_ // 16)) * 16),
                      dtype=torch.bfloat16, device=DEVICE)  # the split [x | h] the phases pass on
    args = args[:13] + (apk.data_ptr(),) + args[14:]
    fn = getattr(_cuda.library(), symbol)
    out = {k: device_ms(lambda a=args[:-2] + (p, args[-1]): fn(*a), 50)
           for k, p in CELL_PARTS.items()}
    del keep
    return out


def cell_phases_line(what: str, call, rows: int, block_rows: int) -> dict:
    ms = cell_phases_ms(call)
    tile = dk.gate_tile(rows, H, dk._sms(torch.device(DEVICE)))
    say(f"  {what} by phase: attention {ms['attention']:.4f} ms ({block_rows} rows a block; "
        + ", ".join(f"{k} {ms[k]:.4f}" for k in list(CELL_PARTS)[1:4])
        + f"), gates {ms['gates']:.4f} ms (tile {tile}: {dk.gate_blocks(rows, H, tile)} blocks; "
        f"without the copy of [x | h] {ms['without the copy of [x | h]']:.4f}) [{CARD}]")
    return {"attend_ms": ms["attention"], "gates_ms": ms["gates"]}


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


def beam_select_bytes(pp, hp, base, sk) -> int:
    """Bytes of one beam_select launch from state ``base`` to ``sk``: the
    partials, h, the histories, tokens and scores read and written, the
    best-caption state, and the token history of each image whose best
    caption improved."""
    improved = int((sk["best_len"] != base["best_len"]).sum().item())
    return (nbytes(*pp, hp, sk["h"], sk["hist_in"], sk["hist_out"])
            + 2 * nbytes(sk["tok"], sk["score"])
            + nbytes(sk["best_val"], sk["best_len"], sk["found"])
            + improved * (MAX_STEPS + 1) * 4)


def greedy_select_bytes(pp, sk, rows: int) -> int:
    """Bytes of one greedy_select launch ending in state ``sk``: the
    partials, and for each row still live h copied and its token written."""
    live = int((sk["done"] == 0).sum().item())
    return nbytes(*pp) + live * (2 * H * 4 + 4) + rows * 4 * 3


def beam_times(model, theta, batches, paths):
    """K1's kernels at step 1 of a full-width batch (bf16 weights).  The
    exit flags are set open, so every timed launch does its whole work."""
    dec = dk.BeamDecoder(model["decoder"], theta, max_steps=MAX_STEPS, device=DEVICE)
    feats, att1, h0, styles = dec.prepare(batches[0], None)
    w = dec.weights()
    wdt = w["fc_w"].dtype
    br = dk.K * dec.block_images  # the served decoder's rows per block of (a)
    state = dk._init_state(h0, MAX_STEPS)
    h1 = dk.cell_step(feats, att1, state["h"], state["tok"], styles, 0, w, block_rows=br)
    dk.beam_select(*dk.logits_top3_partial(h1, w["fc_w"], w["fc_b"]), h1, state, 0, END)
    state["hist_in"], state["hist_out"] = state["hist_out"], state["hist_in"]
    state["run"].fill_(1)
    t = 1  # a step with real embeddings and three live beams per image
    rows = B * dk.K
    vp = w["fc_w"].shape[1]
    C = vp // dk.CHUNK
    per_batch = N_BATCHES * 2  # the main path serves each batch at f32 and bf16
    out = []

    cell = lambda: dk.cell_step(feats, att1, state["h"], state["tok"], styles, t, w,
                                block_rows=br)
    cell_plain = lambda: dk.cell_step_plain(feats, att1, state["h"], state["tok"], styles, t, w)
    hk, hp = cell(), cell_plain()
    out.append(kernel_entry(
        "cell_step (beam rows)", dk.CELL, "beam", BEAM_SOURCE, BEAM_TPU, cell, cell_plain,
        None, *cell_cost(feats, att1, state["h"], state["tok"], styles, w, hk),
        (hk - hp).abs().max().item(), wdt, paths, per_batch))
    out[-1].update(cell_phases_line(f"cell_step (beam rows, B={B})", cell, rows, br))
    tiles = {br: device_ms(lambda br=br: dk.cell_step(feats, att1, state["h"], state["tok"],
                                                      styles, t, w, block_rows=br), 50)
             for br in dk.TILE_ROWS}
    say("  cell_step (beam rows) by rows per block: "
        + ", ".join(f"{br}: {ms:.4f} ms" for br, ms in tiles.items()) + f" (B={B}) [{CARD}]")

    logits = lambda: dk.logits_top3_partial(hp, w["fc_w"], w["fc_b"])
    logits_plain = lambda: dk.logits_top3_partial_plain(hp, w["fc_w"], w["fc_b"])
    h_lib, w32 = hp.to(wdt), w["fc_w"].float()

    def library_on(hh, ww):
        def call():
            x = (torch.matmul(hh, ww).float() + w["fc_b"]).reshape(rows, C, dk.CHUNK)
            return torch.topk(x, 3, dim=2), torch.logsumexp(x, dim=2)
        return call

    pk, pp = logits(), logits_plain()
    check_full_width(pk, pp, "(b)")
    out.append(kernel_entry(
        "logits_top3_partial", dk.LOGITS, "beam", BEAM_SOURCE, BEAM_TPU, logits, logits_plain,
        library_on(hp, w32), nbytes(hp, w["fc_w"], w["fc_b"], *pk), 2 * rows * H * vp,
        (pk[0] - pp[0]).abs().max().item(), wdt, paths, per_batch,
        lib_bf16=library_on(h_lib, w["fc_w"])))
    d16 = depth16_ms(lambda hh, ww: dk.logits_top3_partial(hh, ww, w["fc_b"]), hp, w["fc_w"])
    say(f"  logits_top3_partial at depth 16 (its epilogues, copies and h split with 1/13 of "
        f"the products): {d16:.4f} ms against {out[-1]['ms']:.4f} at depth {H} (B={B}) [{CARD}]")

    base = clone_state(state)
    sk, sp = clone_state(base), clone_state(base)
    dk.beam_select(*pp, hp, sk, t, END)
    dk.beam_select_plain(*pp, hp, sp, t, END)
    sel_bytes = beam_select_bytes(pp, hp, base, sk)
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
    c32 = device_ms(lambda: dk.cell_step(f32_, a32, state["h"], state["tok"], styles, t, w32,
                                         block_rows=dk.K * dec32.block_images), 50)
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
    out[-1].update(cell_phases_line(f"cell_step (greedy rows, B={B})", cell, rows,
                                    dk.GREEDY_BLOCK_ROWS))

    logits = lambda: dk.logits_top1_partial(hp, w["fc_w"], w["fc_b"])
    logits_plain = lambda: dk.logits_top1_partial_plain(hp, w["fc_w"], w["fc_b"])
    h_lib, w32 = hp.to(wdt), w["fc_w"].float()

    def library_on(hh, ww):
        def call():
            x = torch.matmul(hh, ww).float() + w["fc_b"]
            return x.reshape(rows, C, dk.CHUNK).max(dim=2)
        return call

    pk, pp = logits(), logits_plain()
    check_full_width(pk, pp, "(b1)")
    out.append(kernel_entry(
        "logits_top1_partial", dk.LOGITS1, "greedy", GREEDY_SOURCE, GREEDY_TPU, logits,
        logits_plain, library_on(hp, w32), nbytes(hp, w["fc_w"], w["fc_b"], *pk),
        2 * rows * H * vp, (pk[0] - pp[0]).abs().max().item(), wdt, paths, per_batch,
        lib_bf16=library_on(h_lib, w["fc_w"])))
    d16 = depth16_ms(lambda hh, ww: dk.logits_top1_partial(hh, ww, w["fc_b"]), hp, w["fc_w"])
    say(f"  logits_top1_partial at depth 16 (its epilogues, copies and h split with 1/13 of "
        f"the products): {d16:.4f} ms against {out[-1]['ms']:.4f} at depth {H} (B={B}) [{CARD}]")

    base = clone_state(state)
    sk, sp = clone_state(base), clone_state(base)
    dk.greedy_select(*pp, hp, sk, t, END)
    dk.greedy_select_plain(*pp, hp, sp, t, END)
    for k in sk:
        require(torch.equal(sk[k], sp[k]), f"(c1) full width: {k} differs from the plain version")
    # the timed launches repeat step t on a state that its first launch has
    # updated: rows still live after it copy h and write their token
    live = int((sk["done"] == 0).sum().item())
    sel_bytes = greedy_select_bytes(pp, sk, rows)
    scratch = clone_state(base)
    select = lambda: dk.greedy_select(*pp, hp, scratch, t, END)
    scratch_plain = clone_state(base)
    select_plain = lambda: dk.greedy_select_plain(*pp, hp, scratch_plain, t, END)
    with forced_select(pdl=False):  # timed as launched alone, as timed_alone
        out.append(kernel_entry(
            "greedy_select", dk.GREEDY_SELECT, "greedy", GREEDY_SOURCE, GREEDY_TPU, select,
            select_plain, None, sel_bytes, 0, (sk["h"] - sp["h"]).abs().max().item(), wdt,
            paths, per_batch))
    say(f"  (c1) full width: state equal to the plain version; {live}/{rows} rows live "
        f"after step {t}")
    return out


def timed_alone(select) -> float:
    """A select kernel's device time, launched as the other kernels are
    (programmatic dependent launch, which hides part of the launch between
    two selects, is timed apart by ``select_times``)."""
    with forced_select(pdl=False):
        return device_ms(select, 50)


def service_step_times(model, batches) -> None:
    """Each decode kernel at the caption service's batch (ENC_B images on an
    S=3 bank, bf16, the decoder at +MID_BIAS on </s>): K1's three kernels
    at 3 * ENC_B rows and K2's at ENC_B rows, at step 1 with the exit flags
    open, beside their bounds."""
    bank, style_rows, _ = style_bank(model)
    x, rows_in = batches[0][:ENC_B], style_rows[:ENC_B]
    d = mid_copy(model["decoder"])
    for kind in ("beam", "greedy"):
        if kind == "beam":
            dec = dk.BeamDecoder(d, bank, max_steps=MAX_STEPS, device=DEVICE)
            br = dk.K * dec.block_images
            cell = functools.partial(dk.cell_step, block_rows=br)
            cell_plain = dk.cell_step_plain
            logits, select, init = dk.logits_top3_partial, dk.beam_select, dk._init_state
            plains = (dk.logits_top3_partial_plain, dk.beam_select_plain)
            names = ("cell_step (beam rows)", "logits_top3_partial", "beam_select")
        else:
            dec = dk.GreedyDecoder(d, bank, max_len=MAX_LEN, device=DEVICE)
            br = dk.GREEDY_BLOCK_ROWS
            cell = functools.partial(dk.cell_step, zero_word_t0=False, block_rows=br)
            cell_plain = functools.partial(dk.cell_step_plain, zero_word_t0=False)
            logits, select, init = dk.logits_top1_partial, dk.greedy_select, dk._init_greedy_state
            plains = (dk.logits_top1_partial_plain, dk.greedy_select_plain)
            names = ("cell_step (greedy rows)", "logits_top1_partial", "greedy_select")
        feats, att1, h0, styles = dec.prepare(x, rows_in)
        w = dec.weights()
        state = init(h0, MAX_STEPS if kind == "beam" else MAX_LEN)
        h1 = cell(feats, att1, state["h"], state["tok"], styles, 0, w)
        select(*logits(h1, w["fc_w"], w["fc_b"]), h1, state, 0, END)
        if kind == "beam":
            state["hist_in"], state["hist_out"] = state["hist_out"], state["hist_in"]
        state["run"].fill_(1)
        t = 1
        hk = cell(feats, att1, state["h"], state["tok"], styles, t, w)
        parts = logits(hk, w["fc_w"], w["fc_b"])
        scratch = clone_state(state)
        rows = hk.shape[0]
        vp = w["fc_w"].shape[1]
        times = (
            device_ms(lambda: cell(feats, att1, state["h"], state["tok"], styles, t, w), 50),
            device_ms(lambda: logits(hk, w["fc_w"], w["fc_b"]), 50),
            timed_alone(lambda: select(*parts, hk, scratch, t, END)),
        )
        cell_b, cell_f = cell_cost(feats, att1, state["h"], state["tok"], styles, w, hk)
        sk = clone_state(state)
        select(*parts, hk, sk, t, END)
        sel_bytes = (beam_select_bytes(parts, hk, state, sk) if kind == "beam"
                     else greedy_select_bytes(parts, sk, rows))
        bounds = (bound_ms(cell_b, cell_f, w["fc_w"].dtype),
                  bound_ms(nbytes(hk, w["fc_w"], w["fc_b"], *parts), 2 * rows * H * vp,
                           w["fc_w"].dtype),
                  bound_ms(sel_bytes, 0, w["fc_w"].dtype))
        scratch_plain = clone_state(state)
        plain_times = (
            wall_ms(lambda: cell_plain(feats, att1, state["h"], state["tok"], styles, t, w), 5),
            wall_ms(lambda: plains[0](hk, w["fc_w"], w["fc_b"]), 5),
            wall_ms(lambda: plains[1](*parts, hk, scratch_plain, t, END), 5),
        )
        say(f"  {kind} step at the service's batch ({ENC_B} images, {rows} rows, S=3 bank): "
            + ", ".join(f"{n} {ms:.4f} ms" for n, ms in zip(names, times))
            + "; bounds " + ", ".join(f"{b:.6f} ms ({by})" for b, by in bounds)
            + f"; {sum(times):.4f} ms a step; plain versions "
            + ", ".join(f"{ms:.4f}" for ms in plain_times) + f" ms [{CARD}]")
        cell_phases_line(f"cell_step ({kind} rows, the service's batch)",
                         lambda: cell(feats, att1, state["h"], state["tok"], styles, t, w), rows,
                         br)


def select_times(model) -> dict:
    """K1c and K2c (bf16 decoder at +MID_BIAS, one theta) at step 1 of a
    decode of B and ENC_B images, the exit flags open, through
    ``select_times.measure``: the kernel at the served launch shape and at
    the others, launched as the other kernels are; (c1) with programmatic
    dependent launch (PDL); a whole step ((a), (b), (c) or (c1)) and the
    host time of one select call (for (c1) without and with PDL, in turns);
    and the launch floor (an empty kernel, back to back) at the select
    kernels' grids.  -> {"floor": {grid: ms}, (kind, B): record}."""
    lib = sel_probe.floor_library()
    out = {"floor": {f"{b}x{th}": sel_probe.launch_floor_ms(lib, b, th)
                     for b, th in sel_probe.FLOOR_GRIDS}}
    d = mid_copy(model["decoder"])
    for kind in ("beam", "greedy"):
        for n in (B, ENC_B):
            out[(kind, n)] = sel_probe.measure(kind, d, n)
    say_select_times(out, (B, ENC_B))
    return out


def say_select_times(sel: dict, sizes) -> None:
    """The lines of ``select_times``' record at each of ``sizes`` images."""
    sms = dk._sms(torch.device(DEVICE))
    ms = lambda xs: "/".join(f"{x:.4f}" for x in xs)
    say("  launch floor (an empty kernel back to back, blocks x threads): "
        + ", ".join(f"{g} {t:.4f} ms" for g, t in sel["floor"].items()) + f" [{CARD}]")
    for kind in ("beam", "greedy"):
        for n in sizes:
            rec = sel[(kind, n)]
            if kind == "beam":
                served = f"{dk.select_images_per_block(n, sms)} images a block"
                pdl = (f"; a beam step {ms(rec['step_ms'])} ms; the host's time of a select "
                       f"call {ms(rec['host_ms'])} ms")
            else:
                served = f"{dk.greedy_select_warps(n, sms)} warps a block"
                pdl = (f"; with PDL {ms(rec['select_pdl_ms'])} ms back to back; a greedy step "
                       f"{ms(rec['step_ms'])} ms, with PDL {ms(rec['step_pdl_ms'])}; the host's "
                       f"time of a select call {ms(rec['host_ms'])} ms, with PDL "
                       f"{ms(rec['host_pdl_ms'])} (served: PDL "
                       f"{'on' if dk.GREEDY_SELECT_PDL else 'off'})")
            say(f"  {'beam_select' if kind == 'beam' else 'greedy_select'} at B={n} "
                f"({n * (dk.K if kind == 'beam' else 1)} rows): {ms(rec['select_ms'])} ms at "
                f"the served {served}; "
                + ", ".join(f"{k} {ms(v)}" for k, v in rec["variants"].items())
                + pdl + f" [{CARD}]")


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
# shapes that cut the recurrence kernels' cluster tiling, run at every
# cluster shape that fits (C = 2, 4, 8: M = 16, 32, 64 rows): B = M + 1 for
# each M, a B that is not a multiple of 16 (with a CTA holding fewer groups
# than another: H = 40, 5 groups), and T = 1
CLUSTER_EDGE = ((17, 3, 9, 24, 24, 24), (33, 3, 9, 24, 24, 24), (65, 2, 9, 24, 24, 24),
                (21, 5, 7, 16, 24, 40), (11, 1, 9, 24, 24, 24))
# the CPU tests' tolerances (tests/test_torch_train_kernel.py): the forward
# rtol = atol = 1e-5; a gradient rtol 2e-4, atol max(2e-5 * its scale, 1e-6);
# the d_feats fold must equal its plain version (f32 and bf16)
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
K3_KERNELS = ("train_fwd_kernel", "train_bwd_recurrence_kernel", "train_feats_fold_kernel")
# the parts of the recurrence kernels timed apart at full width: the kernel
# with the part left out (train_kernel.SKIP_*); the part's cost is the
# whole less that
K3_PARTS = {"attention": tk.SKIP_ATTENTION, "of it the scores": tk.SKIP_SCORES,
            "of it the context": tk.SKIP_CONTEXT, "gates + GRU": tk.SKIP_GATES,
            "dx/dh": tk.SKIP_REVERSE, "attention backward": tk.SKIP_ATTENTION_BACK}
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


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.float() - ref.float()).abs().max().item()
            / max(ref.float().abs().max().item(), 1e-12))


def check_k3(args, g, what: str, enforce: bool, shape=None, exact: bool = False) -> dict:
    """Every K3 kernel against its plain version on the same inputs: the
    forward's hs; pass 1's per-row gradients, pass-2 rows, d(v_a) partials
    (one per 8 rows) and the fold's operands; the fold on pass 1's operands;
    pass 2a on pass 1's rows; pass 2b on pass 2a's partials; and the eleven
    gradients of the whole backward.  ``shape`` forces the recurrence
    kernels' cluster size (default: train_kernel.cluster_shape's).  f32
    (enforce) is held to the CPU tests' tolerances; otherwise each relative
    error is printed and held to BF16_REL_BOUND.  With ``exact`` (bf16),
    the plain version also runs in f32 on the same (rounded) inputs: an
    output whose bf16 plain version is itself more than BF16_REL_BOUND from
    that f32 one is lost to bf16's roundings on these inputs, and the
    kernel's is held to the f32 one instead, no further from it than the
    plain version plus BF16_REL_BOUND.  -> max abs error per kernel."""
    rel, lost = {}, {}

    def cmp(got, ref, name, grad=True, ref32=None):
        if enforce:
            return (grad_close(got, ref, f"{what} {name}") if grad else
                    close_or_fail(got, ref, f"{what} {name}", FWD_RTOL, FWD_ATOL))
        err = (got.float() - ref.float()).abs().max().item()
        rel[name] = err / max(ref.float().abs().max().item(), 1e-12)
        if ref32 is not None and rel_err(ref, ref32) > BF16_REL_BOUND:
            lost[name] = (rel[name], rel_err(got, ref32), rel_err(ref, ref32))
            require(lost[name][1] <= lost[name][2] + BF16_REL_BOUND,
                    f"{what} {name}: relative error against the f32 plain version "
                    f"{lost[name][1]:.3e}, the bf16 plain version's {lost[name][2]:.3e}")
            return err
        require(rel[name] <= BF16_REL_BOUND, f"{what} {name}: relative error {rel[name]:.3e}")
        return err

    hp = tk.fused_fwd_plain(*args)
    if exact:
        args32 = tuple(a.float() for a in args)
        hp32 = tk.fused_fwd_plain(*args32)
        pp32 = tk.bwd_recurrence_plain(*args32, hp32, g)
        gp32 = tk.fused_bwd_plain(*args32, hp32, g)
    else:
        hp32, gp32 = None, [None] * len(GRAD_NAMES)
        pp32 = (None,) * 4 + ({k: None for k in ROW_NAMES}, None)
    errs = {"train_fwd": cmp(tk.fused_fwd(*args, shape=shape), hp, "hs", grad=False,
                             ref32=hp32)}
    pp = tk.bwd_recurrence_plain(*args, hp, g, fold_operands=True)
    fold_ops, *pk = tk.bwd_recurrence_parts(*args, hp, g, shape=shape)
    d_feats = tk.feats_fold(*fold_ops)
    e1 = [cmp(d_feats, pp[0], "d_feats", ref32=pp32[0])]
    e1 += [cmp(pk[i], pp[i + 1], n, ref32=pp32[i + 1])
           for i, n in enumerate(("d_att1", "d_h0", "d_emb"))]
    e1 += [cmp(pk[3][k], pp[4][k], f"row {k}", ref32=pp32[4][k]) for k in ROW_NAMES]
    e1.append(cmp(pk[4], pp[5], "d_va partials (8 rows each)", ref32=pp32[5]))
    e1 += [cmp(fold_ops[0], pp[6][0], "w_t"), cmp(fold_ops[1], pp[6][1], "dctx_t")]
    errs["train_bwd_recurrence"] = max(e1)
    plain_fold = tk.feats_fold_plain(*fold_ops)
    require(torch.equal(d_feats, plain_fold), f"{what}: train_feats_fold differs from its plain "
            "version (the same roundings in the same order: they must be equal)")
    errs["train_feats_fold"] = cmp(d_feats, plain_fold, "fold on pass 1's operands")
    part_k = tk.wgrad_partial(pk[3])
    part_p = tk.wgrad_partial_plain(pk[3])
    errs["train_wgrad_partial"] = cmp(part_k, part_p, "weight-gradient partials")
    out_k, dva_k = tk.wgrad_reduce(part_k, pk[4])
    out_p, dva_p = tk.wgrad_reduce_plain(part_k, pk[4])
    errs["train_wgrad_reduce"] = max(cmp(out_k, out_p, "reduced weight gradients"),
                                     cmp(dva_k, dva_p, "reduced d_va"))
    gk = tk.fused_bwd(*args, hp, g)
    gp = tk.fused_bwd_plain(*args, hp, g)
    whole = max(cmp(a, b, f"d_{n}", ref32=c) for n, a, b, c in zip(GRAD_NAMES, gk, gp, gp32))
    if not enforce:
        say(f"  {what}: relative error per output (bf16 bound {BF16_REL_BOUND}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    if lost:
        say(f"  {what}: lost to bf16's roundings on these inputs (relative errors: kernel "
            "against the bf16 plain version, kernel and bf16 plain version against the f32 "
            "plain version): " + ", ".join(f"{k} {a:.3e}, {b:.3e}, {c:.3e}"
                                           for k, (a, b, c) in lost.items()))
    errs["whole backward"] = whole
    return errs


def k3_shapes(R_, F_, E_, H_) -> dict:
    """{(pass, dtype): {C: (dynamic shared memory bytes, clusters the card
    runs at once)}} of the recurrence kernels at these sizes."""
    lib = _cuda.library()
    dev = torch.device(DEVICE)
    return {(bwd, name): {c: (lib.train_recurrence_smem(int(bwd), int(bf), c, R_, F_, E_, H_),
                              tk.max_clusters(dev, bwd, bf, c, R_, F_, E_, H_))
                          for c, _ in tk.CLUSTER_SHAPES}
            for bwd in (False, True) for name, bf in (("f32", False), ("bf16", True))}


# train_wgrad_partial's tilings at their edges, (N, In, H) on random rows:
# N not a multiple of the 32-row stage, N below one split's rows (splits with
# no rows), the ones row starting a new 128-row tile (In = H = 128, and
# In = 256), ragged column tiles (3H = 372, 600) and the full width at a
# ragged N
WGRAD_EDGE = ((35, 48, 24), (15, 400, 200), (1, 32, 16), (32 * 33 + 5, 128, 128),
              (773, 256, 124), (25600 + 7, 400, 200))


def wgrad_edges() -> None:
    """train_wgrad_partial against its plain version at WGRAD_EDGE, held to
    the gradient tolerances."""
    for i, (n, n_in, h) in enumerate(WGRAD_EDGE):
        g = torch.Generator(device=DEVICE).manual_seed(60 + i)
        rows = {k: torch.randn((n, w), generator=g, device=DEVICE)
                for k, w in zip(ROW_NAMES, (n_in, 3 * h, h, h, h))}
        err = grad_close(tk.wgrad_partial(rows), tk.wgrad_partial_plain(rows),
                         f"wgrad partials N={n}, In={n_in}, H={h}")
        say(f"  train_wgrad_partial N={n}, In={n_in}, H={h} ({tk.WGRAD_SPLITS} splits): "
            f"max abs err {err:.2e}")


# the d_feats fold's plans at their edges, (B, T, R, F): T R odd (the w_t rows
# of odd images are off 16 bytes) with two regions an item, one element, a
# small odd shape, the training batch of 64 (items of 25 and 24 regions),
# feature blocks (T=64, F=1024: four of 52 chunks and one of 48 in f32) and
# feature blocks of a whole image's regions (B=300: 49 regions an item;
# blocks take several items in turn)
FOLD_EDGE = ((3, 25, 49, 200), (1, 1, 1, 8), (5, 7, 9, 24), (64, 25, 49, 200),
             (2, 64, 9, 1024), (300, 64, 49, 1024))


def fold_operands(b, t, r, f, cdt, seed):
    """w_t [b, t, r] (a softmax over the regions, f32) and dctx_t [b, t, f]
    in ``cdt``, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    w_t = torch.softmax(torch.randn((b, t, r), generator=g, device=DEVICE) * 2, dim=2)
    return w_t, (torch.randn((b, t, f), generator=g, device=DEVICE) * 1e-2).to(cdt)


def fold_edges() -> None:
    """train_feats_fold against its plain version at FOLD_EDGE, f32 and bf16:
    equal (the same roundings in the same order); and a plan the kernel
    cannot take is refused, with no launch counted."""
    dev = torch.device(DEVICE)
    for i, shape in enumerate(FOLD_EDGE):
        for cdt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            w_t, dctx_t = fold_operands(*shape, cdt, 90 + i)
            got = tk.feats_fold(w_t, dctx_t)
            require(torch.equal(got, tk.feats_fold_plain(w_t, dctx_t)),
                    f"train_feats_fold {name} (B, T, R, F) = {shape} differs from its plain "
                    "version")
            say(f"  train_feats_fold {name} (B, T, R, F) = {shape}: equal to its plain version; "
                f"plan {tk.card_fold_plan(dev, *shape, cdt)}")
    w_t, dctx_t = fold_operands(*FOLD_EDGE[0], torch.float32, 90)
    plan = tk.card_fold_plan(dev, *FOLD_EDGE[0], torch.float32)
    out = torch.empty((3, 49, 200), device=DEVICE)
    before = tk.FOLD.launches
    for bad in (plan._replace(grid=plan.grid + 1), plan._replace(smem=plan.smem - 4),
                plan._replace(sets=0), plan._replace(regions=50)):
        try:
            tk.FOLD.launch("train_feats_fold_f32", w_t.data_ptr(), dctx_t.data_ptr(),
                           out.data_ptr(), *FOLD_EDGE[0], bad.regions, bad.chunks, bad.sets,
                           bad.grid, bad.smem, 0, torch.cuda.current_stream().cuda_stream)
        except RuntimeError:
            continue
        raise AssertionError(f"train_feats_fold took a plan it cannot: {bad}")
    require(tk.FOLD.launches == before, "a refused fold launch was counted")
    say("  train_feats_fold refuses plans off fold_plan's (grid, shared memory, sets, regions)")


def train_small_exactness():
    """K3 at small shapes in f32, with an odd batch (a partial row tile)
    and a batch of one row; at the shapes that cut the cluster tiling
    (CLUSTER_EDGE), at every cluster shape that fits, f32 and bf16; the
    weight-gradient pass at its tiling's edges; the d_feats fold at its
    plans' edges; and d(v_a bias) = 0 through the autograd Function on the
    card."""
    wgrad_edges()
    fold_edges()
    for i, shape in enumerate(SMALL_TRAIN):
        b, t = shape[:2]
        args = random_core(*shape, torch.float32, 40 + i)
        g = torch.randn((b, t, shape[-1]), generator=torch.Generator(device=DEVICE)
                        .manual_seed(50 + i), device=DEVICE)
        errs = check_k3(args, g, f"small {shape}", True)
        say(f"  small (B, T, R, F, E, H) = {shape}, f32: max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    for i, shape in enumerate(CLUSTER_EDGE):
        b, t, r_, f_, e_, h_ = shape
        fits = k3_shapes(r_, f_, e_, h_)
        for cdt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = random_core(*shape, cdt, 70 + i)
            g = torch.randn((b, t, h_), generator=torch.Generator(device=DEVICE)
                            .manual_seed(80 + i), device=DEVICE)
            for c, m in tk.CLUSTER_SHAPES:
                if min(fits[(bwd, name)][c][1] for bwd in (False, True)) < 1:
                    continue
                errs = check_k3(args, g, f"edge {shape} {name} C={c}", cdt == torch.float32,
                                shape=c)
                say(f"  edge (B, T, R, F, E, H) = {shape}, {name}, clusters of {c} CTAs "
                    f"({m} rows): max abs err "
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
    require(tk.BWD.launches == 1 and tk.FOLD.launches == 1, "the backward did not run through K3")
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
        per_c = k3_shapes(*(int(x) for x in (args[0].shape[1], args[0].shape[2],
                                             args[3].shape[2], H)))
        say(f"  full width {name}: clusters of "
            + ", ".join(f"{'pass 1' if bwd else 'forward'} "
                        f"{tk.cluster_shape(B, {c: n for c, (_, n) in per_c[(bwd, name)].items()})}"
                        for bwd in (False, True)) + " (C, M)")
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
    """Bytes and operations of the forward, of pass 1 and of the fold at
    these inputs: each input read once, each output written once."""
    feats, att1 = args[0], args[1]
    Bn, R_, F_ = feats.shape
    T_, E_ = args[3].shape[1], args[3].shape[2]
    In, H_ = args[7].shape[0], args[2].shape[1]
    G = 3 * H_
    ins = nbytes(*args)
    fwd_flops = 2 * Bn * T_ * (H_ * H_ + R_ * H_ + R_ * F_ + In * G + H_ * G)
    rows = T_ * Bn * (In + G + 3 * H_) * 4
    fold_in = Bn * T_ * (R_ * 4 + F_ * feats.element_size())
    bwd_flops = fwd_flops + 2 * Bn * T_ * (In * G + H_ * G + R_ * F_ + 2 * R_ * H_ + H_ * H_)
    bwd_bytes = (ins + 2 * nbytes(hs) + nbytes(att1) + Bn * H_ * 4 + Bn * T_ * E_ * 4 + rows
                 + fold_in + (Bn * H_) * 4)
    fold = (fold_in + nbytes(feats), 2 * Bn * T_ * R_ * F_)
    return (ins + nbytes(hs), fwd_flops), (bwd_bytes, bwd_flops), fold


def k3_parts_ms(args, hs, g) -> dict:
    """Device times of the forward and of pass 1 at these inputs with each
    part left out (K3_PARTS), the whole, and with every part left out (the
    exchanges, barriers and loads that remain)."""
    fwd = lambda sk: device_ms(lambda: tk.fused_fwd(*args, skip=sk), 5)
    bwd = lambda sk: device_ms(lambda: tk.bwd_recurrence_parts(*args, hs, g, skip=sk), 3)
    every = tk.SKIP_ATTENTION | tk.SKIP_GATES
    out = {"fwd": {"whole": fwd(0), "rest": fwd(every)},
           "bwd": {"whole": bwd(0), "rest": bwd(every | tk.SKIP_REVERSE | tk.SKIP_ATTENTION_BACK)}}
    for part, bit in K3_PARTS.items():
        if bit not in (tk.SKIP_REVERSE, tk.SKIP_ATTENTION_BACK):
            out["fwd"][part] = out["fwd"]["whole"] - fwd(bit)
        if bit not in (tk.SKIP_SCORES, tk.SKIP_CONTEXT):
            out["bwd"][part] = out["bwd"]["whole"] - bwd(bit)
    return out


FOLD_B = (B, 64)  # the full-width batch; captionax's default training batch
# the fold with parts left out (its skip bits), by what is left
FOLD_PARTS = {"loads and stores": tk.FOLD_SKIP_ARITH, "arithmetic and stores": tk.FOLD_SKIP_STAGE,
              "loads and arithmetic": tk.FOLD_SKIP_STORE,
              "arithmetic": tk.FOLD_SKIP_STAGE | tk.FOLD_SKIP_STORE,
              "none": tk.FOLD_SKIP_ARITH | tk.FOLD_SKIP_STAGE | tk.FOLD_SKIP_STORE}


def fold_times(fold_ops, cdt, name) -> dict:
    """train_feats_fold at FOLD_B images of pass 1's operands (the first rows
    of the B-row batch) beside one torch.bmm of the same sum, its bound and
    the launch floor (an empty kernel of the plan's grid and threads); at B
    images also with parts left out (FOLD_PARTS).  -> {images: ms}."""
    floor_lib = sel_probe.floor_library()
    out = {}
    for n in FOLD_B:
        w_t, dctx_t = fold_ops[0][:n].contiguous(), fold_ops[1][:n].contiguous()
        plan = tk.card_fold_plan(torch.device(DEVICE), *w_t.shape, dctx_t.shape[2], cdt)
        w_mat = w_t.transpose(1, 2).to(cdt)
        out[n] = ms = device_ms(lambda: tk.feats_fold(w_t, dctx_t), 50)
        lib_ms = device_ms(lambda: torch.bmm(w_mat, dctx_t), 50)
        n_bytes = nbytes(w_t, dctx_t) + n * w_t.shape[2] * dctx_t.shape[2] * dctx_t.element_size()
        bms, by = bound_ms(n_bytes, 2 * w_t.numel() * dctx_t.shape[2], cdt)
        floor = sel_probe.launch_floor_ms(floor_lib, plan.grid, plan.threads)
        say(f"  train_feats_fold ({name}) at B={n}: {ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
            f"bound {bms:.4f} ms by {by} ({bms / ms:.1%} of it), launch floor {floor:.4f} ms at "
            f"its grid ({plan.grid} x {plan.threads}); plan {plan} [{CARD}]")
        if n == B:
            say(f"    by part, what is left: " + ", ".join(
                f"{k} {device_ms(lambda: tk.feats_fold(w_t, dctx_t, skip=bits), 50):.4f}"
                for k, bits in FOLD_PARTS.items()) + " ms")
    return out


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
        fold_ops, d_att1, d_h0, d_emb, rows, dva_part = tk.bwd_recurrence_parts(*args, hs, g)
        partial = tk.wgrad_partial(rows)
        fold_ms = fold_times(fold_ops, cdt, name)
        (fb, ff), (bb, bf), (ob, of) = k3_cost(args, hs)
        parts = k3_parts_ms(args, hs, g)
        for p_name, ms_by in parts.items():
            say(f"  {'train_fwd' if p_name == 'fwd' else 'train_bwd_recurrence'} ({name} "
                f"compute) by part: whole {ms_by['whole']:.4f} ms; "
                + ", ".join(f"{k} {v:.4f}" for k, v in ms_by.items() if k not in ("whole", "rest"))
                + f" (each the whole less the kernel without it); with every part left out "
                f"{ms_by['rest']:.4f} [{CARD}]")
        ones = lambda a: torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
        x1, hp1 = ones(rows["x"]), ones(rows["hp"])
        dgh = torch.cat([rows["dgi"][:, :2 * H], rows["dghn"]], dim=1)
        lib_wgrad = lambda: (torch.matmul(x1.t(), rows["dgi"]), torch.matmul(hp1.t(), dgh),
                             torch.matmul(hp1.t(), rows["datt2"]))
        lib_reduce = lambda: (torch.sum(partial, dim=0), torch.sum(dva_part, dim=0))
        # the same sum of w_t dctx_t over t, as one batched product in another
        # order (and, in bf16, without the fold's rounding at every step)
        w_fold = fold_ops[0].transpose(1, 2).to(cdt)
        lib_fold = lambda: torch.bmm(w_fold, fold_ops[1])
        total = partial.shape[1]
        specs = [
            ("train_fwd", tk.FWD, K3_FWD_TPU, lambda: tk.fused_fwd(*args),
             lambda: tk.fused_fwd_plain(*args), None, fb, ff, cdt),
            ("train_bwd_recurrence", tk.BWD, K3_BWD_TPU,
             lambda: tk.bwd_recurrence_parts(*args, hs, g),
             lambda: tk.bwd_recurrence_plain(*args, hs, g), None, bb, bf, cdt),
            ("train_feats_fold", tk.FOLD, K3_BWD_TPU, lambda: tk.feats_fold(*fold_ops),
             lambda: tk.feats_fold_plain(*fold_ops), lib_fold, ob, of, cdt),
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
                if op is tk.FOLD:
                    out[-1]["ms_b64"] = fold_ms[FOLD_B[1]]
    return out


# ------------------------------------------------------------------ 16-19: images in
ENC_DEPTH = 152
ENC_B = 64            # the caption service's micro-batch (CaptionService's default)
IMG = 224
N_MICRO = 3           # concurrent micro-batches served in phase 18
STYLES = ("factual", "humorous", "romantic")
K4_SOURCE = "captionax_torch/ops/csrc/conv_stage.cu"
K4_TPU = "captionax/ops/conv_kernel.py:60"
K4_F32_TOL = 1e-4     # K4 vs its plain version, relative to the output's largest entry
K4_BF16_TOL = 2e-2    # small shapes; full width: K4_FULL_BF16_TOL
K4_FULL_BF16_TOL = 5e-2
ENCODER_F32_TOL = 1e-3
# small K4 cases (stage, first block, blocks, B): every stage's widths at
# reduced depth and odd B, stage 1's block 0 with its projection, single
# blocks; row counts that are not a multiple of the bf16 kernel's 128-row
# tile (all but one) and one that is (stage 1, B=2: 6272 = 49 * 128), and
# stage 4 at B=1 (49 rows, less than one tile).  bf16 runs each case at
# every pair of tile widths (N = M, N = C) the kernel takes for its M and C
K4_SMALL = ((0, 0, 2, 1), (0, 0, 1, 5), (1, 1, 2, 3), (2, 1, 3, 5), (3, 1, 1, 3),
            (0, 1, 2, 2), (2, 1, 2, 2), (3, 1, 2, 1))


def k4_resnet(seed: int = 2):
    """ResNet-152 with every folded scale and bias drawn from a seed.
    ``resnet_init`` zeroes each conv3 scale, so each block would output
    ReLU(identity) and a K4 that got conv1, conv2 or conv3 wrong would
    still agree; conv3 scales in [0.1, 0.2] keep 36 residual blocks finite."""
    g = gen(seed)
    params = resnet_init(g, ENC_DEPTH, device=DEVICE)

    def fold(p, lo, hi):
        c = p["scale"].numel()
        p["scale"] = (lo + (hi - lo) * torch.rand(c, generator=g)).to(DEVICE)
        p["bias"] = (0.1 * torch.randn(c, generator=g)).to(DEVICE)

    fold(params["stem"], 0.5, 1.5)
    for blocks in params["stages"]:
        for blk in blocks:
            for name, p in blk.items():
                fold(p, *((0.1, 0.2) if name == "conv3" else (0.5, 1.5)))
    return params


def random_images(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def check_k4(x, packed, what: str, f32: bool, tol: float) -> tuple:
    """K4 against its plain version on the same input; -> (relative error,
    max abs error)."""
    got = ck.fused_stage(x, packed, f32=f32)
    ref = ck.fused_stage_plain(x, packed, f32=f32)
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == ref.dtype, f"{what}: {got.shape} {got.dtype}")
    require(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    rel = rel_err(got, ref)
    say(f"  {what}: max error {rel:.3e} of the largest entry "
        f"{ref.float().abs().max().item():.3f} [{CARD}]")
    require(rel <= tol, f"{what}: error {rel} > {tol}")
    return rel, (got.float() - ref.float()).abs().max().item()


def width_pairs(m: int, c: int) -> list:
    """Every pair of bf16 tile widths (N = m, N = c) the kernel takes."""
    return [(bm, bc) for bm in ck.TILE_WIDTHS if m % bm == 0
            for bc in ck.TILE_WIDTHS if c % bc == 0]


@contextlib.contextmanager
def forced_widths(bn_m: int, bn_c: int, m: int):
    """Within: the bf16 K4 launches take tile width bn_m where N = m and
    bn_c elsewhere, in place of ``tile_width``'s choice."""
    chosen = ck.tile_width
    ck.tile_width = lambda rows, n: bn_m if n == m else bn_c
    try:
        yield
    finally:
        ck.tile_width = chosen


def k4_small(enc) -> None:
    """(16) every K4 stage configuration at small batch and depth against the
    plain version, f32 and bf16 (the latter at every pair of tile widths);
    each chain must not be ReLU(input)."""
    cg = torch.Generator(device=DEVICE).manual_seed(16)
    for s, b0, n, b in K4_SMALL:
        blocks = enc["stages"][s][b0:b0 + n]
        S, cin = 56 >> s, blocks[0]["conv1"]["kernel"].shape[2]
        x = torch.relu(torch.randn((b, S, S, cin), generator=cg, device=DEVICE))
        packed = ck.pack_stage(blocks)
        what = (f"K4 stage {s + 1} blocks {b0}..{b0 + n - 1}"
                f"{' with projection' if 'downsample' in blocks[0] else ''}, B={b}, S={S}")
        check_k4(x, packed, f"{what}, f32", True, K4_F32_TOL)
        M, C = packed["w2"].shape[2], packed["w3"].shape[2]
        for bm, bc in width_pairs(M, C):
            with forced_widths(bm, bc, M):
                check_k4(x, packed, f"{what}, bf16, tile widths {bm} (N=M), {bc} (N=C)", False,
                         K4_BF16_TOL)
        if cin == blocks[0]["conv3"]["kernel"].shape[3]:
            out = ck.fused_stage(x, packed, f32=True)
            gap = rel_err(out, torch.relu(x))
            require(gap > 1e-2, f"{what}: the chain returns ReLU(input) ({gap})")


def stage_inputs(encoder: CNNEncoder, images: torch.Tensor) -> list:
    """The input of each stage's chain for ``images`` (plain route)."""
    dt = encoder.compute_dtype
    x = resnet_stem(encoder.params["stem"], images, dt)
    ins = []
    for s, blocks in enumerate(encoder.params["stages"]):
        if s > 0:
            x = _first_block(x, blocks[0], dt)
        ins.append(x.contiguous())
        x = ck.fused_stage_plain(x, encoder.chains[s], f32=dt == torch.float32)
    return ins


def k4_full(enc, images: np.ndarray):
    """(17) ResNet-152 at B=64: each stage's K4 call against its plain
    version at the same input, f32 (enforced) and bf16; then the whole
    encoder_cnn in f32 against the plain route."""
    x = preprocess_images(torch.from_numpy(images).to(DEVICE))
    encoders = {dt: CNNEncoder(enc, dt, DEVICE) for dt in (torch.float32, torch.bfloat16)}
    ins, errs = {}, {}
    for dt, encoder in encoders.items():
        f32 = dt == torch.float32
        ins[dt] = stage_inputs(encoder, x)
        for s, xs in enumerate(ins[dt]):
            errs[(dt, s)] = check_k4(
                xs, encoder.chains[s], f"K4 stage {s + 1}, B={ENC_B}, S={xs.shape[1]}, "
                f"{'f32' if f32 else 'bf16'}", f32, K4_F32_TOL if f32 else K4_FULL_BF16_TOL)
    got = encoders[torch.float32](x)
    ref = encoders[torch.float32].plain(x)
    require(tuple(got.shape) == (ENC_B, 49, 2048), f"encoder_cnn: {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), "encoder_cnn: non-finite features")
    rel = rel_err(got, ref)
    say(f"  encoder_cnn f32 [{ENC_B}, 49, 2048] K4 vs plain route: max error {rel:.3e} of the "
        f"largest entry {ref.abs().max().item():.3f} [{CARD}]")
    require(rel <= ENCODER_F32_TOL, f"encoder_cnn f32: error {rel} > {ENCODER_F32_TOL}")
    return encoders, x, ins, errs


def synthetic_vocab(seed: int = 3) -> Vocab:
    """A 9,684-word vocab from a seed (``data/seeded_corpus.py``)."""
    return seeded_vocab(seed, V)


def serve_concurrently(svc, images, rows):
    """Every image as its own caption_array request, all from their own
    threads at once, then one request alone; -> (answers, seconds for the
    concurrent ones, seconds for the single one, dispatches)."""
    dispatches = []
    inner = svc._batcher.decode_fn
    svc._batcher.decode_fn = lambda f, r: (dispatches.append(1) or inner(f, r))
    answers = [None] * len(images)
    gate = threading.Barrier(len(images) + 1)

    def ask(i):
        gate.wait()
        answers[i] = svc.caption_array(images[i], STYLES[rows[i]])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(images))]
    try:
        for th in threads:
            th.start()
        gate.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join(timeout=600)
        many = time.perf_counter() - t0
        require(not any(th.is_alive() for th in threads), "a request did not finish")
        require(all(a is not None for a in answers), "a request failed")
        t0 = time.perf_counter()
        answers.append(svc.caption_array(images[0], STYLES[rows[0]]))
        one = time.perf_counter() - t0
    finally:
        svc._batcher.decode_fn = inner
    return answers, many, one, len(dispatches)


def check_captions(answers, vocab, what: str, beam: bool) -> None:
    for a in answers:
        require(isinstance(a["caption"], str) and a["style"] in STYLES, f"{what}: {a}")
        require(all(w in vocab.w2i for w in a["caption"].split()), f"{what}: unknown word")
        if beam:
            require(np.isfinite(a["score"]) and (a["score"] <= 0 if a["completed"]
                                                 else a["caption"] == ""), f"{what}: {a}")
    words = [len(a["caption"].split()) for a in answers]
    done = np.mean([a["completed"] for a in answers]) if beam else float("nan")
    say(f"  {what}: {len(answers)} captions well formed, {np.mean(words):.2f} words on "
        f"average (max {max(words)})" + (f", {done:.4f} completed" if beam else ""))


def service_path(model, enc, images, rows, decode: str):
    """(18) The caption service on the card, bf16 as captionax serves it:
    N_MICRO concurrent micro-batches of 64 and one single request, through
    K4 and K1 (or K2); its captions against a direct decode of the same
    features; then f32 features through the f32 decode against the plain
    route.  -> (the service, K4 launches by chain width, the direct bf16
    decoder)."""
    vocab = synthetic_vocab()
    params = {"decoder": mid_copy(model["decoder"]), "hn": model["hn"]}
    steps = MAX_STEPS if decode == "beam" else MAX_LEN
    kernels = dk.BEAM_KERNELS if decode == "beam" else dk.GREEDY_KERNELS
    svc = CaptionService(params, enc, vocab, STYLES, batch_size=ENC_B, max_steps=steps,
                         decode=decode, device=DEVICE)
    try:
        (answers, many, one, n_disp), launches = count_launches(
            lambda: serve_concurrently(svc, images, rows), f"{decode} service",
            tuple(kernels) + ck.KERNELS)
        by_width = dict(ck.LAUNCHES_BY_WIDTH)
        say(f"  {decode} service: K4 launches by chain width {by_width}")
        stats = svc.stats()
        say(f"  {decode} service: {len(images)} concurrent requests in {n_disp} dispatches, "
            f"{many:.3f} s ({len(images) / many:.1f} captions/s), then one request alone in "
            f"{one * 1e3:.2f} ms; p50 {stats['p50_ms']} ms, p95 {stats['p95_ms']} ms over "
            f"{stats['served']} requests [{CARD}]")
        require(stats["served"] == len(images) + 1 and stats["errors"] == 0, f"stats {stats}")
        check_captions(answers, vocab, f"{decode} service", decode == "beam")
        say(f"  {decode} service: the single request's caption "
            f"{'equals' if answers[-1] == answers[0] else 'differs from'} its answer in a "
            f"micro-batch")
        ids = torch.tensor([resolve_style_id(params, vocab, s) for s in STYLES], device=DEVICE)
        bank = synthesize_theta_batched(params, style_table(params)[ids])
        x = preprocess_images(torch.from_numpy(images).to(DEVICE))
        dev_rows = torch.from_numpy(rows).to(DEVICE)
        # the direct decode in the service's batches of 64 (the stem's and the
        # first blocks' cuDNN algorithms may differ with the batch size)
        chunks = [slice(i, i + ENC_B) for i in range(0, len(images), ENC_B)]
        if decode == "beam":
            direct = dk.BeamDecoder(params["decoder"], bank, max_steps=steps, device=DEVICE)
            texts = [ids_to_text(t, vocab) for c in chunks for t in unpack_beam_result(fetch(
                pack_beam_result(direct(svc.encoder(x[c]), dev_rows[c])))).tokens]
        else:
            direct = dk.GreedyDecoder(params["decoder"], bank, max_len=steps, device=DEVICE)
            texts = [ids_to_text(t, vocab) for c in chunks
                     for t in fetch(direct(svc.encoder(x[c]), dev_rows[c]))]
        equal = [a["caption"] == t for a, t in zip(answers, texts)]
        same = float(np.mean(equal))
        say(f"  {decode} service vs a direct decode of the same images: {same:.4f} of "
            f"captions equal [{CARD}]")
        for i in np.flatnonzero(~np.array(equal))[:5]:
            say(f"  {decode} service image {i}: {answers[i]['caption']!r} vs {texts[i]!r}")
        require(same >= FULL_AGREEMENT, f"{decode} service: agreement {same}")
        enc32 = CNNEncoder(enc, torch.float32, DEVICE)
        f_k, f_p = enc32(x), enc32.plain(x)
        if decode == "beam":
            d32 = dk.BeamDecoder(params["decoder"], bank, max_steps=steps, f32=True,
                                 device=DEVICE)
            got = unpack_beam_result(fetch(pack_beam_result(d32(f_k, dev_rows))))
            agreement([got], [d32.forward_plain(f_p, dev_rows)],
                      "f32 features and beam: K4 + K1 vs plain route", enforce=True)
        else:
            d32 = dk.GreedyDecoder(params["decoder"], bank, max_len=steps, f32=True,
                                   device=DEVICE)
            greedy_agreement([fetch(d32(f_k, dev_rows))],
                             [d32.forward_plain(f_p, dev_rows).cpu().numpy()],
                             "f32 features and greedy: K4 + K2 vs plain route", enforce=True)
        return svc, by_width, direct
    except BaseException:
        svc.close()
        raise


def k4_cost(x, packed, out) -> tuple:
    """Bytes (the input, every operand the chain reads and the output, each
    once) and FLOPs of one chain."""
    n, _, M, _ = packed["w2"].shape
    C, cin = packed["w3"].shape[2], x.shape[3]
    rows = x.shape[0] * x.shape[1] * x.shape[2]
    unread = ("w1r", "sb1r") if n == 1 else ()
    n_bytes = sum(t.numel() * t.element_size() for k, t in packed.items()
                  if t is not None and k not in unread)
    n_bytes += x.numel() * x.element_size() + out.numel() * out.element_size()
    flops = 2 * rows * (n * (9 * M * M + M * C) + cin * M + (n - 1) * C * M)
    if packed["wd"] is not None:
        flops += 2 * rows * cin * C
    return n_bytes, flops


def cudnn_chain(blocks, dt):
    """The library yardstick of a chain: channels-last ``F.conv2d`` (cuDNN)
    and the elementwise scale/bias/residual/ReLU epilogue in ``dt``, weights
    prepared once.  Never called by the port."""
    def prep(p):
        w = p["kernel"].permute(3, 2, 0, 1).to(dt).contiguous(memory_format=torch.channels_last)
        return w, p["scale"].to(dt).view(1, -1, 1, 1), p["bias"].to(dt).view(1, -1, 1, 1)

    prepped = [{k: prep(p) for k, p in blk.items()} for blk in blocks]

    def conv(t, p, pad=0):
        return F.conv2d(t, p[0], padding=pad) * p[1] + p[2]

    def run(x):
        x = x.permute(0, 3, 1, 2)
        for blk in prepped:
            y = torch.relu(conv(x, blk["conv1"]))
            y = torch.relu(conv(y, blk["conv2"], 1))
            ident = conv(x, blk["downsample"]) if "downsample" in blk else x
            x = torch.relu(conv(y, blk["conv3"]) + ident)
        return x.permute(0, 2, 3, 1)

    return run


def k4_times(enc, encoders, x, ins, errs, served, images, rows):
    """(19) K4 per stage against its bound, its plain version and the cuDNN
    chain (CUDA events); the encoder per batch on both routes and by part;
    where a served dispatch's time goes: the pageable upload, the
    preprocess, the encoder, the decode, and the card's busy share."""
    by_width = served["beam"][1]
    entries = []
    for dt, iters in ((torch.bfloat16, 10), (torch.float32, 3)):
        f32 = dt == torch.float32
        for s, xs in enumerate(ins[dt]):
            chain = encoders[dt].chains[s]
            blocks = enc["stages"][s] if s == 0 else enc["stages"][s][1:]
            before = sum(op.launches for op in ck.KERNELS)
            out = ck.fused_stage(xs, chain, f32=f32)
            per_call = sum(op.launches for op in ck.KERNELS) - before
            require(per_call > 0, f"K4 stage {s + 1}: a kernel was not launched")
            per_call = max(per_call, 1)
            n_bytes, flops = k4_cost(xs, chain, out)
            ms = device_ms(lambda: ck.fused_stage(xs, chain, f32=f32), iters)
            plain_ms = wall_ms(lambda: ck.fused_stage_plain(xs, chain, f32=f32), 2)
            lib = cudnn_chain(blocks, dt)
            lib_ms = device_ms(lambda: lib(xs), iters)
            bms, by = bound_ms(n_bytes, flops, dt)
            say(f"  K4 stage {s + 1} {'f32' if f32 else 'bf16'} (B={ENC_B}, S={xs.shape[1]}, "
                f"{len(blocks)} blocks): {ms:.4f} ms per call, {ms / per_call:.4f} ms per launch "
                f"({per_call} launches), {flops / ms / 1e9:.1f} TFLOP/s; bound {bms:.4f} ms by "
                f"{by} ({bms / ms:.1%} of it); plain {plain_ms:.4f} ms; cuDNN chain "
                f"{lib_ms:.4f} ms [{CARD}]")
            if not f32:
                entries.append({
                    "name": f"conv_stage stage {s + 1} (conv1x1_bn, conv3x3_bn; bf16)",
                    "route": "cuda", "source": K4_SOURCE, "replaces": K4_TPU,
                    "launches": by_width.get(chain["w3"].shape[2], 0),
                    "launches_per_call": per_call, "max_abs_err": errs[(dt, s)][1], "ms": ms,
                    "ms_per_launch": ms / per_call, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms,
                })
    enc16 = encoders[torch.bfloat16]
    p16, ins16 = enc16.params, ins[torch.bfloat16]
    outs = [ck.fused_stage(xs, enc16.chains[s]) for s, xs in enumerate(ins16)]
    stem_ms = device_ms(lambda: resnet_stem(p16["stem"], x, torch.bfloat16), 10)
    first_ms = [device_ms(lambda s=s: _first_block(outs[s - 1], p16["stages"][s][0],
                                                   torch.bfloat16), 10) for s in (1, 2, 3)]
    chain_ms = [device_ms(lambda s=s: ck.fused_stage(ins16[s], enc16.chains[s]), 5)
                for s in range(4)]
    enc_ms = device_ms(lambda: enc16(x), 5)
    plain_ms = wall_ms(lambda: enc16.plain(x), 2)
    say(f"  encoder bf16, a batch of {ENC_B}: K4 route {enc_ms:.3f} ms (stem {stem_ms:.3f}; "
        f"stride-2 first blocks " + ", ".join(f"{t:.3f}" for t in first_ms) + "; K4 chains "
        + ", ".join(f"{t:.3f}" for t in chain_ms) + f" ms), plain route {plain_ms:.3f} ms "
        f"[{CARD}]")
    batch = images[:ENC_B]
    u8 = torch.from_numpy(batch).to(DEVICE)
    pre_ms = device_ms(lambda: preprocess_images(u8), 20)
    up_ms = wall_ms(lambda: torch.from_numpy(batch).to(DEVICE), 10)
    pinned = torch.from_numpy(batch).pin_memory()
    pin_ms = wall_ms(lambda: pinned.to(DEVICE, non_blocking=True), 10)
    feats = enc16(x)
    dev_rows = torch.from_numpy(rows[:ENC_B]).to(DEVICE)
    for decode, (svc, _, decoder) in served.items():
        finish = pack_beam_result if decode == "beam" else (lambda r: r)
        dec_ms = wall_ms(lambda: fetch(finish(decoder(feats, dev_rows))), 3)
        dispatch = svc._batcher.decode_fn
        disp_ms = wall_ms(lambda: fetch(dispatch(batch, rows[:ENC_B])), 3)
        try:
            busy = kernel_busy_ms(lambda: fetch(dispatch(batch, rows[:ENC_B])))
            share = (f"card busy {busy:.3f} ms of it ({busy / disp_ms:.1%})" if busy > 0
                     else "card busy time not measured (no device time traced)")
        except Exception as exc:  # a measurement, not a check
            share = f"card busy time not measured ({type(exc).__name__}: {exc})"
        say(f"  a served {decode} dispatch of {ENC_B} images: {disp_ms:.3f} ms (host clock to "
            f"the fetched result; {share}): pageable upload of the {batch.nbytes / 1e6:.1f} MB "
            f"uint8 batch {up_ms:.3f} ms (pinned {pin_ms:.3f} ms), preprocess {pre_ms:.3f} ms, "
            f"encoder {enc_ms:.3f} ms ({enc_ms / disp_ms:.1%}), decode "
            f"{'and pack ' if decode == 'beam' else ''}to the fetched result {dec_ms:.3f} ms "
            f"({int(decoder.last_steps)} steps run) [{CARD}]")
    return entries


def k4_width_sweep(encoders, ins) -> None:
    """(19) K4 bf16 per stage at B=64 at every pair of tile widths (N = M,
    N = C) the kernel takes, CUDA events: the measurements behind
    ``tile_width``'s rule, printed beside its choice."""
    enc16 = encoders[torch.bfloat16]
    for s, xs in enumerate(ins[torch.bfloat16]):
        chain = enc16.chains[s]
        M, C = chain["w2"].shape[2], chain["w3"].shape[2]
        rows = xs.shape[0] * xs.shape[1] * xs.shape[2]
        times = []
        for bm, bc in width_pairs(M, C):
            with forced_widths(bm, bc, M):
                times.append((device_ms(lambda: ck.fused_stage(xs, chain), 5), bm, bc))
        say(f"  K4 stage {s + 1} bf16 (B={ENC_B}) by tile widths (N=M, N=C), ms per call: "
            + ", ".join(f"({bm}, {bc}) {ms:.4f}" for ms, bm, bc in sorted(times))
            + f"; tile_width chooses ({ck.tile_width(rows, M)}, {ck.tile_width(rows, C)}) "
            f"[{CARD}]")


# ------------------------------------------------------------------ 20: the training CLIs
# 480 images split 384 / 48 / 48: the 384 training images are six batches of
# 64 exactly, so epoch 2 draws only images epoch 1 cached, and the encoder
# must not run in it (with 512 the split leaves 409, of which an epoch takes
# 384, and epoch 2 would meet some images for the first time)
CLI_IMAGES = 480
CLI_BATCH = 64
CLI_EPOCHS = 2
CLI_GRU_IMAGES = 128
CLI_AGREEMENT = 0.99   # evaluate's beam tokens against the training CLI's, as phases 4-9 judge
CLI_METRIC_TOL = 1e-6
CLI_STYLES = ("factual", "humour", "romantic")


def cli_corpus(tmp: str) -> list:
    """A vocab pickle (``synthetic_vocab``'s 9,684 words) and a factual
    caption file (five captions of 8-15 of its words per image) in ``tmp``
    -> the CLIs' data flags."""
    return seeded_corpus(tmp, CLI_IMAGES, CLI_BATCH)


def cli_counts() -> dict:
    return {op.name: op.launches for op in tk.KERNELS + ck.KERNELS}


def reset_cli_counts() -> None:
    for op in tk.KERNELS + ck.KERNELS:
        op.launches = 0
    ck.LAUNCHES_BY_WIDTH.clear()


class SpyTrainer(harness.CaptionTrainer):
    """The harness with phase 20's readings: each train step timed on the
    host clock with a sync before and after (and the first step's state,
    batch and loss kept), each featurize timed the same way with the K4
    launches it made, each test_beam timed, and fit's seconds and its K3
    and K4 launches.  ``record`` is set before each CLI run."""

    record: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rec = SpyTrainer.record
        self.rec.update(trainer=self, steps=[], featurize=[], test_beam=[])
        self._in_eval = False
        self._timer = StepTimer()
        step = self._train_step

        def timed_step(state, batch):
            new, m = self._timed(step, state, batch)
            self.rec["steps"].append(self._timer.times[-1] * 1e3)
            self.rec.setdefault("first", (state, batch, m["train_loss"]))
            return new, m

        self._train_step = timed_step

    def _timed(self, fn, *args):
        """fn(*args) on the StepTimer's host clock, with a wait for the card
        before and after (fn's results may hold no tensor on the card)."""
        torch.cuda.synchronize()
        self._timer.start()
        out = fn(*args)
        torch.cuda.synchronize()
        self._timer.stop()
        return out

    def _featurize(self, batch):
        k4 = ck.CONV1X1.launches + ck.CONV3X3.launches
        out = self._timed(super()._featurize, batch)
        self.rec["featurize"].append({
            "ms": self._timer.times[-1] * 1e3, "images": len(out["captions"]),
            "k4": ck.CONV1X1.launches + ck.CONV3X3.launches - k4,
            "train_step": None if self._in_eval else len(self.rec["steps"])})
        return out

    def validate(self, *args, **kwargs):
        self._in_eval = True
        try:
            return super().validate(*args, **kwargs)
        finally:
            self._in_eval = False

    def test_beam(self, batches):
        self._in_eval = True
        try:
            out = self._timed(super().test_beam, batches)
        finally:
            self._in_eval = False
        self.rec["test_beam"].append(self._timer.times[-1] * 1e3)
        return out

    def fit(self, *args, **kwargs):
        before = cli_counts()
        width_before = dict(ck.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        out = super().fit(*args, **kwargs)
        torch.cuda.synchronize()
        self.rec["fit_seconds"] = time.perf_counter() - t0
        self.rec["fit_counts"] = {k: v - before[k] for k, v in cli_counts().items()}
        self.rec["fit_by_width"] = {w: n - width_before.get(w, 0)
                                    for w, n in ck.LAUNCHES_BY_WIDTH.items()}
        return out


@contextlib.contextmanager
def cli_spies(saved: dict, beams: list, mods=(cli_gru, cli_hypernet, cli_evaluate)):
    """SpyTrainer in the CLIs ``mods`` (the three training CLIs); every
    checkpoint save also keeps a copy of the tree (``saved[step]``); every
    beam_search of test_beam keeps its features, tokens and found flags
    (``beams``)."""
    save, search = tckpt.save_checkpoint, harness.beam_search

    def saving(directory, step, tree, max_to_keep=1):
        saved[int(step)] = [x.detach().clone() for x in tree_leaves(tree)]
        return save(directory, step, tree, max_to_keep)

    def searching(decoder, features, *args, **kwargs):
        res = search(decoder, features, *args, **kwargs)
        beams.append((features, res.tokens.clone(), res.found.clone()))
        return res

    tckpt.save_checkpoint, harness.beam_search = saving, searching
    for m in mods:
        m.CaptionTrainer = SpyTrainer
    try:
        yield
    finally:
        tckpt.save_checkpoint, harness.beam_search = save, search
        for m in mods:
            m.CaptionTrainer = harness.CaptionTrainer


def cli_core(params, batch, kind: str, cdt) -> tuple:
    """The recurrence's inputs of a CLI train step on its own params and
    batch, as make_*_steps builds them (theta from the f32 hypernet, then
    bf16 copies of the decoder and theta under bf16 compute)."""
    batch = {k: torch.as_tensor(batch[k]).to(DEVICE) for k in ("features", "captions", "style_id")
             if k in batch}
    with torch.no_grad():
        theta = None
        if kind == "hypernet":
            theta = hypernet_apply(params["hn"], tsteps.style_token_embed(params, batch))
            params = params["decoder"]
        if cdt == torch.bfloat16:
            params = tsteps._bf16(params)
            theta = None if theta is None else tsteps._bf16(theta)
        return tk.core_inputs(params, batch["features"].to(cdt), batch["captions"], theta)


def check_cli_k3(params, batch, kind: str, cdt, what: str, seed: int) -> None:
    """check_k3 on a CLI step's own inputs (and a random d hs of 1e-3):
    f32 held to the CPU tests' tolerances, bf16 to BF16_REL_BOUND (and,
    where the bf16 plain version itself strays beyond it, against the f32
    plain version: ``check_k3(exact=True)``)."""
    args = cli_core(params, batch, kind, cdt)
    b, t = args[3].shape[:2]
    g = torch.randn((b, t, H), generator=torch.Generator(device=DEVICE).manual_seed(seed),
                    device=DEVICE) * 1e-3
    errs = check_k3(args, g, what, cdt == torch.float32, exact=cdt == torch.bfloat16)
    say(f"  {what}, (B, T) = ({b}, {t}), every K3 kernel against its plain version: max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" [{CARD}]")


def logged(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def training_clis() -> dict:
    """(20) train_hypernet at full width through the CLI as a user runs it
    (--fused-scan: K3; the encoder in the feature cache: K4), then evaluate
    on its checkpoint, then train_gru in bf16 through K3.  -> K3's and K4's
    launches during train_hypernet's fit, by kernel and by K4 chain width."""
    rec: dict = {}
    saved, beams = {}, []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="captionax-cli-") as tmp, cli_spies(saved, beams):
        data = cli_corpus(tmp)
        ckdir = os.path.join(tmp, "hypernet")
        flags = data + ["--synthetic-images", str(CLI_IMAGES), "--checkpoint-dir", ckdir,
                        "--fused-scan", "--cache-features-device"]
        SpyTrainer.record = rec
        reset_cli_counts()
        t0 = time.perf_counter()
        hist = cli_hypernet.main(flags + ["--max-epochs", str(CLI_EPOCHS), "--log-every", "1",
                                          "--run-name", "phase20"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = cli_counts()
        trainer = rec["trainer"]
        fit = rec["fit_counts"]
        say(f"  train_hypernet, {CLI_IMAGES} images, B={CLI_BATCH}, {CLI_EPOCHS} epochs, "
            f"--fused-scan --cache-features-device: {run_s:.2f} s; launches during fit "
            + ", ".join(f"{k} {v}" for k, v in fit.items()) + "; in the whole run "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + "; K4 during fit by chain width " + str(rec["fit_by_width"]))
        for op in tk.KERNELS + ck.KERNELS:
            require(fit[op.name] > 0, f"{op.name} was not launched during the CLI's fit")
        steps = rec["steps"]
        per_epoch = int(CLI_IMAGES * 0.8) // CLI_BATCH
        require(len(steps) == CLI_EPOCHS * per_epoch, f"{len(steps)} train steps")
        train_feats = [f for f in rec["featurize"] if f["train_step"] is not None]
        cold = [f for f in train_feats if f["train_step"] < per_epoch]
        warm = [f for f in train_feats if f["train_step"] >= per_epoch]
        require(len(warm) == per_epoch and all(f["k4"] == 0 for f in warm),
                "the encoder ran in epoch 2: " + str([f["k4"] for f in warm]))
        require(all(f["k4"] > 0 for f in cold), "a cold batch did not run the encoder")
        losses = [r["train_loss"] for r in logged(os.path.join(ckdir, "phase20.jsonl"))
                  if "train_loss" in r]
        require(len(losses) == len(steps) and all(np.isfinite(losses)),
                f"logged train losses: {losses}")
        require(all(np.isfinite(h["train_loss_epoch"]) and np.isfinite(h["val_loss_tf"])
                    for h in hist.values()), f"epoch metrics: {hist}")

        # the first step again through the per-step loop, on the same state and batch
        state0, batch0, loss0 = rec["first"]
        loop, _ = make_hypernet_steps(trainer.tx, fused_scan=False)
        loop_loss = float(loop(state0, batch0)[1]["train_loss"])
        rel = abs(float(loss0) - loop_loss) / abs(loop_loss)
        say(f"  first step: K3 loss {float(loss0):.6f}, per-step loop {loop_loss:.6f}, "
            f"relative difference {rel:.2e} (bound {TRAIN_LOSS_RTOL})")
        require(rel <= TRAIN_LOSS_RTOL, "the CLI's first K3 step differs from the loop's")
        check_cli_k3(state0.params, batch0, "hypernet", torch.float32,
                     f"phase 20 train_hypernet first step f32 B={CLI_BATCH}", 21)

        # the checkpoint: bit for bit the params saved at its step
        last = tckpt.latest_step(ckdir)
        restored = tckpt.restore_checkpoint(ckdir, like=trainer.params)
        require(last in saved and all(
            a.device == b.device and torch.equal(a, b)
            for a, b in zip(tree_leaves(restored), saved[last])),
            f"checkpoint step {last} does not restore to the params saved at it")
        state_dir = os.path.join(tmp, "state")
        tckpt.save_train_state(state_dir, trainer.global_step, trainer.state)
        back = tckpt.restore_train_state(state_dir, trainer.state)
        mine = tree_leaves([trainer.state.params, list(trainer.state.opt_state),
                            trainer.state.step])
        require(all(torch.equal(a, b) for a, b in zip(
            tree_leaves([back.params, list(back.opt_state), back.step]), mine)),
            "restore_train_state does not give back the state")
        say(f"  checkpoint: step {last} of {trainer.global_step} restores bit for bit "
            f"({len(saved[last])} tensors); the train state (Adam's moments, count "
            f"{int(back.opt_state.adam.count)}, step {int(back.step)}) round-trips exactly")

        # evaluate on that checkpoint
        trained = {s: {k[len(f'test_{s}_'):]: v for r in logged(os.path.join(ckdir, "phase20.jsonl"))
                       for k, v in r.items() if k.startswith(f"test_{s}_")} for s in CLI_STYLES}
        n_train_beams = len(beams)
        require(n_train_beams == len(CLI_STYLES), f"{n_train_beams} beam decodes in the test")
        test_beam_ms = rec["test_beam"]
        SpyTrainer.record = {}
        t0 = time.perf_counter()
        results = cli_evaluate.main(flags + ["--kind", "hypernet"])
        eval_s = time.perf_counter() - t0
        for i, style in enumerate(CLI_STYLES):
            (_, tt, tf), (_, et, ef) = beams[i], beams[n_train_beams + i]
            same = ((tt == et).all(dim=1) & (tf == ef)).float().mean().item()
            got, ref = results[style], trained[style]
            require(all(np.isfinite(float(v)) for v in got.values()), f"evaluate {style}: {got}")
            if last == trainer.global_step:
                require(same >= CLI_AGREEMENT, f"evaluate {style}: tokens agree on {same:.4f}")
                if same == 1.0:
                    worst = max(abs(float(got[k]) - ref[k]) for k in ref)
                    require(set(got) == set(ref) and worst <= CLI_METRIC_TOL,
                            f"evaluate {style}: metrics differ by {worst}")
            say(f"  evaluate {style}: tokens of {len(tf)} images agree with the training "
                f"CLI's test on {same:.4f}; beam_completed {got['beam_completed']}, "
                f"beam_bleu1 {got.get('beam_bleu1', float('nan')):.4f}, tf_bleu1 "
                f"{got['tf_bleu1']:.4f}")
        step_ms = float(np.median(steps[1:]))
        say(f"  train_hypernet times: {step_ms:.2f} ms per train step (median of steps "
            f"2-{len(steps)}, host clock, a sync before and after; first step "
            f"{steps[0]:.1f} ms), {CLI_BATCH / step_ms * 1e3:.1f} images/s; featurize cold "
            f"{np.median([f['ms'] for f in cold]):.2f} ms per batch of {CLI_BATCH} (the "
            f"encoder), warm {np.median([f['ms'] for f in warm]):.3f} ms (the f16 table); "
            "test_beam " + ", ".join(f"{ms:.1f}" for ms in test_beam_ms)
            + f" ms per batch of {CLI_IMAGES // 10} (one per style); evaluate {eval_s:.2f} s "
            f"[{CARD}]")

        # train_gru in bf16 through K3
        SpyTrainer.record = grec = {}
        reset_cli_counts()
        ghist = cli_gru.main(data + ["--synthetic-images", str(CLI_GRU_IMAGES), "--checkpoint-dir",
                                     os.path.join(tmp, "gru"), "--bf16-compute", "--fused-scan",
                                     "--cache-features-device", "--max-epochs", "1"])
        torch.cuda.synchronize()
        gcounts = cli_counts()
        for op in tk.KERNELS:
            require(grec["fit_counts"][op.name] > 0, f"train_gru bf16: {op.name} not launched")
        gstate, gbatch, _ = grec["first"]
        check_cli_k3(gstate.params, gbatch, "gru", torch.bfloat16,
                     f"phase 20 train_gru step bf16 B={CLI_BATCH}", 22)
        require(all(np.isfinite(h["train_loss_epoch"]) for h in ghist.values()),
                f"train_gru bf16: {ghist}")
        say(f"  train_gru --bf16-compute --fused-scan, {CLI_GRU_IMAGES} images: train loss "
            f"{ghist[0]['train_loss_epoch']:.6f}, val_loss_tf {ghist[0]['val_loss_tf']:.6f}; "
            f"{grec['steps'][0]:.1f} ms for its one step; launches "
            + ", ".join(f"{k} {v}" for k, v in gcounts.items()) + f" [{CARD}]")
    say(f"  the training CLIs' phase: {time.perf_counter() - t_phase:.2f} s [{CARD}]")
    return {"counts": fit, "by_width": rec["fit_by_width"]}


# ------------------------------------------------------------------ 21: the caption and serve CLIs
CAP_FILES = 256       # image files written for phase 21
CAP_REQUESTS = 192    # --requests rows and concurrent HTTP requests
CAP_AGREEMENT = 0.99  # captions equal to a direct decode / to caption's, as phase 18 judges
INT8_MEAN_REL, INT8_COSINE = 0.1, 0.99  # captionax's int8 bounds (tests/test_encoder.py)
INT8_TOPS = 1979e12   # dense int8 tensor-core peak of the H100 SXM
SUP_HANDOVERS = 2
SUP_CLIENTS = 8
SUP_DEADLINE_S = 180


def image_decoder() -> str:
    """Which route decodes image files here: the native library (built from
    csrc/imgdec.cc), PIL, or neither (then phase 21 cannot read files)."""
    native = native_image.native_available()
    why = ""
    if not native:
        try:
            ctypes.CDLL(str(native_build.build(native_image.SOURCE, native_image.LIBS)))
        except subprocess.CalledProcessError as exc:
            lines = (exc.stderr or b"").decode(errors="replace").strip().splitlines()
            why = f" ({lines[0] if lines else exc})"
        except (OSError, subprocess.SubprocessError) as exc:
            why = f" ({type(exc).__name__}: {exc})"
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    route = "native" if native else ("PIL" if pil != "no PIL" else "none")
    say(f"  image decoders on this machine: csrc/imgdec.cc {'builds' if native else 'does not build'}"
        f"{why}; {pil}; files decode through: {route} [{CARD}]")
    require(route != "none", "no image decoder on this machine: neither csrc/imgdec.cc "
            "(g++ with libjpeg/libpng) nor PIL; the file legs of phase 21 cannot run")
    return route


def write_images(img_dir: str) -> list:
    """CAP_FILES seeded images of mixed sizes, every eighth gray: two thirds
    JPEG and a third PNG where PIL is present, else all PNG."""
    os.makedirs(img_dir)
    rs = np.random.RandomState(21)
    paths = []
    for i in range(CAP_FILES):
        h, w = rs.randint(96, 481, 2)
        arr = rs.randint(0, 256, (h, w, 3), np.uint8)
        arr = arr[..., 0] if i % 8 == 7 else arr
        paths.append(os.path.join(img_dir, write_image(img_dir, f"img{i:03d}", arr, i % 3 != 2)))
    return paths


def torchvision_state_dict(enc) -> dict:
    """A folded ResNet tree -> a torchvision-layout state dict (OIHW
    kernels; BN gamma = scale, beta = bias, mean 0, var 1 - eps), which
    ``from_torch_state_dict`` folds back."""
    sd = {}

    def put(conv, bn, p):
        sd[conv + ".weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous().cpu()
        c = p["scale"].numel()
        sd[bn + ".weight"], sd[bn + ".bias"] = p["scale"].cpu(), p["bias"].cpu()
        sd[bn + ".running_mean"] = torch.zeros(c)
        sd[bn + ".running_var"] = torch.full((c,), 1.0 - 1e-5)

    put("conv1", "bn1", enc["stem"])
    for s, blocks in enumerate(enc["stages"]):
        for b, blk in enumerate(blocks):
            pre = f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                put(f"{pre}.conv{i}", f"{pre}.bn{i}", blk[f"conv{i}"])
            if "downsample" in blk:
                put(f"{pre}.downsample.0", f"{pre}.downsample.1", blk["downsample"])
    return sd


class TimedPipeline(PipelinedDecoder):
    """The caption CLI's pipeline, timed from its first batch to its last
    result (host decode, encoder, decode and the JSONL rows in between)."""

    runs: list = []

    def map(self, feature_batches):
        t0, n = time.perf_counter(), 0
        for out in super().map(feature_batches):
            n += 1
            yield out
        TimedPipeline.runs.append((time.perf_counter() - t0, n))


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def direct_texts(params, vocab, paths, rows_or_style, encoder, decode: str) -> list:
    """The captions of a direct decode of ``paths``: load_paths_batch ->
    CNNEncoder -> BeamDecoder / GreedyDecoder, in batches of ENC_B, one
    theta (a style) or the bank with per-row styles (rows)."""
    if isinstance(rows_or_style, str):
        gru, rows = synthesize_theta(params, resolve_style_id(params, vocab, rows_or_style)), None
    else:
        styles = sorted(set(rows_or_style))
        ids = torch.tensor([resolve_style_id(params, vocab, s) for s in styles], device=DEVICE)
        gru = synthesize_theta_batched(params, style_table(params)[ids])
        rows = np.asarray([styles.index(s) for s in rows_or_style], np.int32)
    if decode == "beam":
        dec = dk.BeamDecoder(params["decoder"], gru, max_steps=MAX_STEPS, device=DEVICE)
    else:
        dec = dk.GreedyDecoder(params["decoder"], gru, max_len=MAX_STEPS, device=DEVICE)
    texts = []
    for i in range(0, len(paths), ENC_B):
        imgs = native_image.load_paths_batch(paths[i:i + ENC_B])
        feats = encoder(preprocess_images(torch.from_numpy(imgs).to(DEVICE)))
        res = dec(feats, None if rows is None else torch.from_numpy(rows[i:i + ENC_B]))
        toks = (fetch(res) if decode == "greedy"
                else unpack_beam_result(fetch(pack_beam_result(res))).tokens)
        texts += [ids_to_text(t, vocab) for t in toks]
    return texts


def caption_runs(tmp, flags, paths, params, vocab, encoder) -> dict:
    """(21, 3) caption.main: beam over three styles, greedy, --requests;
    each path's launches, its rows in order, and its captions against a
    direct decode.  -> {run: (launches, K4 launches by width, rows, s)}."""
    rs = np.random.RandomState(0)
    reqs = [(os.path.basename(paths[i]), STYLES[s])
            for i, s in enumerate(rs.randint(0, len(STYLES), CAP_REQUESTS))]
    req_path = os.path.join(tmp, "requests.jsonl")
    with open(req_path, "w") as f:
        f.write("\n".join(json.dumps({"image": n, "style": s}) for n, s in reqs))
    runs = {
        "beam": (["--decode", "beam", "--styles", ",".join(STYLES)], dk.BEAM_KERNELS),
        "greedy": (["--decode", "greedy"], dk.GREEDY_KERNELS),
        "requests": (["--requests", req_path], dk.BEAM_KERNELS),
    }
    out = {}
    for name, (extra, kernels) in runs.items():
        path = os.path.join(tmp, f"caption_{name}.jsonl")
        TimedPipeline.runs = []
        t0 = time.perf_counter()
        n, launches = count_launches(
            lambda: cli_caption.main(flags + extra + ["--out", path]), f"caption --{name}",
            tuple(kernels) + ck.KERNELS)
        wall = time.perf_counter() - t0
        by_width = dict(ck.LAUNCHES_BY_WIDTH)
        rows = read_jsonl(path)
        if name == "requests":
            want = reqs
            texts = direct_texts(params, vocab, [os.path.join(tmp, "images", r) for r, _ in reqs],
                                 [s for _, s in reqs], encoder, "beam")
        else:
            styles = STYLES if name == "beam" else ("factual",)
            want = [(os.path.basename(p), s) for s in styles for p in paths]
            texts = [t for s in styles
                     for t in direct_texts(params, vocab, paths, s, encoder, name)]
        require(n == len(rows) == len(want), f"caption {name}: {n} rows, {len(rows)} written")
        require([(r["image"], r["style"]) for r in rows] == want, f"caption {name}: rows order")
        keys = {"image", "style", "caption"} | ({"score", "completed"} if name != "greedy"
                                                 else set())
        require(all(set(r) == keys for r in rows), f"caption {name}: {rows[0]}")
        equal = [r["caption"] == t for r, t in zip(rows, texts)]
        same = float(np.mean(equal))
        stream = sum(t for t, _ in TimedPipeline.runs)
        say(f"  caption --{name}: {len(rows)} rows, {sum(equal)}/{len(rows)} ({same:.4f}) equal "
            f"to a direct decode (load_paths_batch, CNNEncoder, "
            f"{'GreedyDecoder' if name == 'greedy' else 'BeamDecoder'}); "
            f"{len(rows) / stream:.1f} images/s over its {len(TimedPipeline.runs)} streams "
            f"({stream:.2f} s), {wall:.2f} s the whole call; K4 by chain width {by_width} "
            f"[{CARD}]")
        for i in np.flatnonzero(~np.array(equal))[:5]:
            say(f"  caption --{name} row {i}: {rows[i]['caption']!r} vs {texts[i]!r}")
        require(same >= CAP_AGREEMENT, f"caption {name}: agreement {same}")
        out[name] = (launches, by_width, rows, stream)
    return out


def post_all(port: int, items) -> tuple:
    """Every (bytes, style) as its own POST /caption, all at once from their
    own threads; -> (answers, per-request seconds, seconds for all)."""
    import urllib.request

    answers, lat = [None] * len(items), [0.0] * len(items)
    gate = threading.Barrier(len(items) + 1)

    def ask(i):
        data, style = items[i]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/caption?style={style}",
                                     data=data, headers={"Content-Type": "image/jpeg"})
        gate.wait()
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            answers[i] = (r.status, json.loads(r.read()))
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(items))]
    for th in threads:
        th.start()
    gate.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    many = time.perf_counter() - t0
    require(not any(th.is_alive() for th in threads), "an HTTP request did not finish")
    require(all(a is not None for a in answers), "an HTTP request failed")
    return answers, np.asarray(lat), many


def http_get(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        require(r.status == 200, f"GET {path}: {r.status}")
        return json.loads(r.read())


class Int8Spy:
    """Within: every int8 conv of the encoder also computes its plain
    version's int32 sums (``check``; they must be equal), counts its bytes
    (the int8 input, the weights, the int32 output, each once) and
    operations, and records CUDA events around the product itself (im2col
    and ``torch._int_mm``)."""

    def __init__(self, check: bool):
        self.real, self.check, self.convs, self.n_bytes, self.ops = tenc.int8_conv, check, 0, 0, 0
        self.events = []

    def __call__(self, qx, q, stride=1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = self.real(qx, q, stride)
        end.record()
        self.events.append((start, end))
        kh, _, cin, cout = q.shape
        if self.check:
            cols = tenc.im2col(qx, kh, stride).reshape(-1, kh * kh * cin)
            ref = tenc.int8_matmul_plain(cols, q.reshape(-1, cout))
            require(torch.equal(y.reshape(-1, cout), ref), f"int8 conv {self.convs}: the int32 "
                    "sums differ from the plain version's")
        self.convs += 1
        self.n_bytes += qx.numel() + q.numel() + y.numel() * 4
        self.ops += 2 * y.numel() * kh * kh * cin
        return y

    def products_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def __enter__(self):
        tenc.int8_conv = self
        return self

    def __exit__(self, *exc):
        tenc.int8_conv = self.real
        return False


def int8_checks(svc8, enc_params, images: np.ndarray, bf16_ms_fn) -> None:
    """(21, 4) The int8 service's encoder on one batch of written images:
    each int8 conv's int32 sums against its plain version, the features
    against the f32 encoder (K4's f32 route) within captionax's bounds, and
    its time beside the bf16 encoder's and the int8 bound."""
    x = preprocess_images(torch.from_numpy(images).to(DEVICE))
    with Int8Spy(check=True) as spy:
        q = svc8.encoder(x)
        torch.cuda.synchronize()
    with Int8Spy(check=False) as timed:
        svc8.encoder(x)
        products_ms = timed.products_ms()
    f32 = CNNEncoder(enc_params, torch.float32, DEVICE)(x)
    require(tuple(q.shape) == tuple(f32.shape) == (len(images), 49, 2048), f"int8 {q.shape}")
    require(bool(torch.isfinite(q).all()), "int8 features: non-finite")
    mean_rel = ((q - f32).abs().mean() / (f32.abs().mean() + 1e-6)).item()
    cos = F.cosine_similarity(q.flatten(), f32.flatten(), dim=0).item()
    int8_ms = device_ms(lambda: svc8.encoder(x), 5)
    bf16_ms = bf16_ms_fn(x)
    bms, by = max((spy.n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (spy.ops / INT8_TOPS * 1e3, "operations"))
    say(f"  int8 encoder, a batch of {len(images)} files: {spy.convs} int8 convs, each's int32 sums "
        f"equal to the plain version's (im2col + an f64 product); features against the f32 "
        f"encoder: mean |d| / mean |f| {mean_rel:.4f} (bound {INT8_MEAN_REL}), cosine {cos:.5f} "
        f"(bound {INT8_COSINE}); {int8_ms:.3f} ms per batch (bf16 encoder {bf16_ms:.3f}), of it "
        f"the int8 products (im2col, torch._int_mm) {products_ms:.3f} ms; their bound "
        f"{bms:.4f} ms by {by} ({spy.ops / 1e12:.3f} TOP, {spy.n_bytes / 1e6:.1f} MB) [{CARD}]")
    require(mean_rel < INT8_MEAN_REL and cos > INT8_COSINE, "int8 features outside captionax's "
            f"bounds: {mean_rel}, {cos}")


def http_services(flags, paths, beam_rows, enc_params) -> dict:
    """(21, 4) serve's build_service on the card, bf16 then --int8-encoder,
    behind make_http_server: 192 concurrent POSTs of file bytes across the
    three styles, answers against caption's for the same file and style;
    /healthz and /stats.  -> {"bf16"/"int8": launches}."""
    rs = np.random.RandomState(0)
    picks = [(paths[i], STYLES[s]) for i, s in enumerate(rs.randint(0, len(STYLES), CAP_REQUESTS))]
    items = []
    for path, style in picks:
        with open(path, "rb") as f:
            items.append((f.read(), style))
    by_caption = {(r["image"], r["style"]): r["caption"] for r in beam_rows}
    serve_flags = flags + ["--styles", ",".join(STYLES), "--window", str(ENC_B)]
    out, texts = {}, {}
    for kind in ("bf16", "int8"):
        args = cli_serve.make_serve_parser().parse_args(
            serve_flags + (["--int8-encoder"] if kind == "int8" else []))
        t0 = time.perf_counter()
        svc = cli_serve.build_service(args)
        build_s = time.perf_counter() - t0
        srv = make_http_server(svc, "127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            port = srv.server_address[1]
            kernels = dk.BEAM_KERNELS + (ck.KERNELS if kind == "bf16" else ())
            first = post_all(port, items[:1])[2]  # one request alone: the first dispatch's costs
            (answers, lat, many), launches = count_launches(
                lambda: post_all(port, items), f"serve {kind}", kernels)
            k4 = sum(op.launches for op in ck.KERNELS)
            launches.update({op.name: op.launches for op in ck.KERNELS})
            require(kind == "bf16" or k4 == 0, f"the int8 service launched K4 {k4} times")
            for (status, body), (_, style) in zip(answers, items):
                require(status == 200 and body["style"] == style and isinstance(body["caption"], str)
                        and set(body) == {"caption", "score", "completed", "style"},
                        f"serve {kind}: {status} {body}")
                require(all(w in svc.vocab.w2i for w in body["caption"].split()),
                        f"serve {kind}: unknown word")
            texts[kind] = [b["caption"] for _, b in answers]
            health, stats = http_get(port, "/healthz"), http_get(port, "/stats")
            require(health == {"status": "ok", "styles": list(STYLES), "decode": "beam"},
                    f"healthz {health}")
            require(stats["served"] == len(items) + 1 and stats["errors"] == 0, f"stats {stats}")
            if kind == "bf16":
                same = np.mean([t == by_caption[(os.path.basename(p), s)]
                                for t, (p, s) in zip(texts[kind], picks)])
                say(f"  serve bf16: {len(items)} concurrent POST /caption in {many:.3f} s "
                    f"({len(items) / many:.1f} captions/s), client p50 "
                    f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 {np.percentile(lat, 95) * 1e3:.1f}"
                    f" ms; /stats p50 {stats['p50_ms']} ms, p95 {stats['p95_ms']} ms, rss "
                    f"{stats.get('rss_mb')} MB; {same:.4f} of captions equal caption's for the "
                    f"same file and style; build_service {build_s:.2f} s, then one request alone "
                    f"{first * 1e3:.1f} ms [{CARD}]")
                require(same >= CAP_AGREEMENT, f"serve bf16 vs caption: {same}")
                bf16_encoder = svc.encoder
            else:
                agree = np.mean([a == b for a, b in zip(texts["int8"], texts["bf16"])])
                say(f"  serve --int8-encoder: {len(items)} concurrent POST /caption in {many:.3f} s"
                    f" ({len(items) / many:.1f} captions/s), client p50 "
                    f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 {np.percentile(lat, 95) * 1e3:.1f}"
                    f" ms; beam captions equal to the bf16 service's on {agree:.4f}; "
                    f"build_service (calibration included) {build_s:.2f} s, then one request alone "
                    f"{first * 1e3:.1f} ms [{CARD}]")
                int8_checks(svc, enc_params, native_image.load_paths_batch(paths[:ENC_B]),
                            lambda x: device_ms(lambda: bf16_encoder(x), 5))
            out[kind] = (launches, dict(ck.LAUNCHES_BY_WIDTH))
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
    return out


def proc_started(pid: int) -> float:
    """A process's start on the host's wall clock (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def supervised(tmp: str, flags, paths, base_rss_mb: float) -> dict:
    """(21, 5) python -m captionax_torch.cli.serve --rss-limit-mb below a
    worker's RSS, as a subprocess: the supervisor rolls its workers without
    pause while SUP_CLIENTS threads post images; >= SUP_HANDOVERS handovers
    with zero client errors.  ``base_rss_mb`` is this process's RSS once it
    had torch, a CUDA context and the kernel library: every worker holds at
    least as much, so half of it is below any worker's RSS."""
    import urllib.request

    limit = base_rss_mb / 2
    port = free_port()
    argv = [sys.executable, "-m", "captionax_torch.cli.serve", *flags, "--styles",
            ",".join(STYLES), "--window", str(ENC_B), "--port", str(port), "--rss-limit-mb",
            f"{limit:.0f}", "--drain-grace", "1"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_path = os.path.join(tmp, "supervisor.log")
    t_start = time.time()
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    events, ready = [], {}
    lock = threading.Lock()

    def pump():
        with open(log_path, "w") as log:
            for line in proc.stdout:
                now = time.time()
                log.write(f"{now - t_start:9.3f} {line}")
                m = re.match(r"\[worker (\d+)\] (.*)", line)
                with lock:
                    if m and "WORKER_READY" in m[2]:
                        pid = int(m[1])
                        try:
                            ready[pid] = now - proc_started(pid)
                        except OSError:
                            ready[pid] = float("nan")
                    if "; rolling" in line or (m and "activated" in m[2]):
                        events.append((now, line.strip()))

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    stop = threading.Event()
    errors, done = [], []
    blobs = []
    for p in paths[:32]:
        with open(p, "rb") as f:
            blobs.append(f.read())

    def client(ci):
        i = ci
        while not stop.is_set():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/caption?style={STYLES[i % len(STYLES)]}",
                    data=blobs[i % len(blobs)], headers={"Content-Type": "image/jpeg"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    body = json.loads(r.read())
                    ok = r.status == 200 and isinstance(body.get("caption"), str)
                with lock:
                    (done if ok else errors).append((time.time(), body))
            except Exception as exc:  # every client error counts against the handover
                with lock:
                    errors.append((time.time(), repr(exc)))
            i += SUP_CLIENTS

    clients = []
    try:
        deadline = time.time() + SUP_DEADLINE_S
        while not ready and time.time() < deadline and proc.poll() is None:
            time.sleep(0.2)
        require(bool(ready), "the first serve worker did not become ready")
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(SUP_CLIENTS)]
        for th in clients:
            th.start()
        while (sum("activated" in e for _, e in events) < SUP_HANDOVERS
               and time.time() < deadline and proc.poll() is None):
            time.sleep(0.5)
        time.sleep(2.0)  # traffic on the last worker too
    finally:
        stop.set()
        for th in clients:
            th.join(timeout=150)
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)  # the supervisor retires its workers
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                pass
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # and nothing of the group outlives the phase
        proc.wait()
        reader.join(timeout=30)
    rolls = [t for t, e in events if "; rolling" in e]
    acts = [t for t, e in events if "activated" in e]
    worker_rss = [m[1] for _, e in events for m in [re.search(r"rss (\d+) MB", e)] if m]
    times = sorted(t for t, _ in done)
    gaps = np.diff(times) if len(times) > 1 else np.zeros(1)
    starts = [s for s in ready.values() if np.isfinite(s)]
    say(f"  serve --rss-limit-mb {limit:.0f} (half this process's RSS after phase 1, "
        f"{base_rss_mb:.0f} MB, below any worker's; workers rolled at " + ", ".join(worker_rss)
        + f" MB): {len(acts)} handovers, {len(done)} "
        f"requests answered, {len(errors)} client errors from {SUP_CLIENTS} clients; worker start "
        f"to ready " + ", ".join(f"{s:.2f}" for s in starts) + " s; rolling -> activated "
        + ", ".join(f"{(a - r) * 1e3:.0f}" for r, a in zip(rolls, acts)) + " ms; the longest "
        f"pause between answers {gaps.max() * 1e3:.0f} ms [{CARD}]")
    for t, e in errors[:5]:
        say(f"  client error at {t - t_start:.2f} s: {e}")
    if len(acts) < SUP_HANDOVERS or errors:
        with open(log_path) as f:
            say("  the supervisor's output (seconds from its start):\n"
                + "".join(f.readlines()[-40:]))
    require(len(acts) >= SUP_HANDOVERS, f"{len(acts)} handovers")
    require(not errors, f"{len(errors)} client errors across the handovers")
    require(len(done) > SUP_CLIENTS, f"only {len(done)} requests answered")
    return {"start_s": starts, "handovers": len(acts)}


def caption_and_serve(model, enc, base_rss_mb: float) -> dict:
    """(21) The caption and serve CLIs as a user runs them, at full width:
    256 seeded image files, a port checkpoint of the hypernet model (+0.26
    on </s>), the seeded vocab and a ResNet-152 state dict; caption.main
    (beam, greedy, --requests), build_service behind HTTP (bf16, int8) and
    the supervised serve CLI.  -> launches by path."""
    t_phase = time.perf_counter()
    route = image_decoder()
    with tempfile.TemporaryDirectory(prefix="captionax-serve-") as tmp:
        paths = write_images(os.path.join(tmp, "images"))
        t0 = time.perf_counter()
        imgs = native_image.load_paths_batch(paths[:ENC_B])
        decode_ms = [(time.perf_counter() - t0) * 1e3]
        for _ in range(2):
            t0 = time.perf_counter()
            native_image.load_paths_batch(paths[ENC_B:2 * ENC_B])
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        require(imgs.shape == (ENC_B, IMG, IMG, 3) and imgs.dtype == np.uint8, f"{imgs.shape}")
        say(f"  host batch decode ({route}) of {ENC_B} files to {IMG}x{IMG}: "
            + ", ".join(f"{ms:.1f}" for ms in decode_ms) + f" ms [{CARD}]")
        params = {"decoder": mid_copy(model["decoder"]), "hn": model["hn"]}
        vocab = synthetic_vocab()
        vocab_path, ckdir = os.path.join(tmp, "vocab.pkl"), os.path.join(tmp, "ckpt")
        with open(vocab_path, "wb") as f:
            pickle.dump(vocab, f)
        tckpt.save_checkpoint(ckdir, 1, params)
        sd_path = os.path.join(tmp, "resnet152.pt")
        torch.save(torchvision_state_dict(enc), sd_path)
        enc_params = from_torch_state_dict(torch.load(sd_path), ENC_DEPTH, device=DEVICE)
        encoder = CNNEncoder(enc_params, torch.bfloat16, DEVICE)
        model_flags = ["--vocab-path", vocab_path, "--checkpoint-dir", ckdir,
                       "--encoder-weights", sd_path, "--encoder-depth", str(ENC_DEPTH),
                       "--num-features", str(NF), "--feature-size", str(FO), "--embed-size",
                       str(E), "--hidden-size", str(H), "--batch-size", str(ENC_B),
                       "--beam-max-steps", str(MAX_STEPS), "--device", DEVICE]
        cli_caption.PipelinedDecoder = TimedPipeline
        try:
            caps = caption_runs(tmp, model_flags + ["--images", os.path.join(tmp, "images")],
                                paths, params, vocab, encoder)
        finally:
            cli_caption.PipelinedDecoder = PipelinedDecoder
        served = http_services(model_flags, paths, caps["beam"][2], enc_params)
        sup = supervised(tmp, model_flags, paths, base_rss_mb)
    say(f"  the caption and serve CLIs' phase: {time.perf_counter() - t_phase:.2f} s [{CARD}]")
    return {"caption": {k: v[:2] for k, v in caps.items()}, "serve": served, "sup": sup}


# ------------------------------------------------------------------ 22: the style classifiers and losses
STYLE_EPOCHS = {"mixup": 2, "style_aux": 1, "mixup_split": 1}
FED_BACK_AGREEMENT = 0.99   # fed-back words of the first mixup step, card against CPU
STYLE_CE_RTOL = 1e-5
STYLE_LOSS_RTOL = 1e-4
STYLE_GRAD_SHARE = 1e-3     # of each gradient's largest entry (or of 1e-3 where that is smaller)
BERT_PROB_TOL = 1e-4
BERT_LR = 1e-4              # a BERT fine-tuning rate; the CLI's default 5e-3 saturates the probe


class ClassifierTimer:
    """train_classifier's optimizer steps timed on the host clock with a
    wait for the card before and after each (``ms``)."""

    def __init__(self):
        self.ms, self._step = [], cli_classifier.classifier_step

    def __enter__(self):
        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._step(*args)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        cli_classifier.classifier_step = timed
        return self

    def __exit__(self, *exc):
        cli_classifier.classifier_step = self._step
        return False


def train_probe(flags: list, kind: str, path: str, extra=()) -> tuple:
    """train_classifier --kind ``kind`` --save ``path`` on the card ->
    (held-out accuracy, ms per step, steps, the run's seconds)."""
    with ClassifierTimer() as timer:
        t0 = time.perf_counter()
        _, acc = cli_classifier.main(flags + ["--kind", kind, "--save", path, *extra])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    require(len(timer.ms) > 1 and os.path.getsize(path) > 0, f"{kind}: {len(timer.ms)} steps")
    return acc, float(np.median(timer.ms[1:])), len(timer.ms), run_s


def style_step_on(step, device):
    """The same style-loss step with its classifier on ``device``."""
    return type(step)(step.tx, to_device(step.classifier_params, device), step.pad_id,
                      step.alpha, step.style_ids, step.embed_fn)


def share_of(got, ref) -> float:
    """max |got - ref| over ref's largest entry (at least 1e-3)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-3)


def check_first_mixup_step(trainer, state0, batch0) -> dict:
    """The first mixup step's loss and gradients on the card against the
    port's f32 on the CPU, on the same weights, batch, coeff and missing
    (drawn as the harness draws them for step 0)."""
    step = trainer.style_step
    coeff, missing = step.draws(harness.step_generator(trainer.config.seed, int(state0.step)))
    cpu = style_step_on(step, "cpu")
    pc, bc = to_device(state0.params, "cpu"), to_device(batch0, "cpu")
    with torch.no_grad():
        words = [tsteps.free_run_logits(p["decoder"], b, tsteps.mixup_theta(
            p, step.style_ids, coeff, missing))[:, :-1].argmax(-1).cpu()
            for p, b in ((state0.params, batch0), (pc, bc))]
    agree = (words[0] == words[1]).float().mean().item()
    rows_same = (words[0] == words[1]).all(dim=1).float().mean().item()
    mk, gk = step.value_and_grad(state0.params, batch0, coeff, missing)
    mp, gp = cpu.value_and_grad(pc, bc, coeff, missing)
    ce_rel = abs(float(mk["ce_loss"]) - float(mp["ce_loss"])) / abs(float(mp["ce_loss"]))
    loss_rel = abs(float(mk["train_loss"]) - float(mp["train_loss"])) / abs(float(mp["train_loss"]))
    grad = max(share_of(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    say(f"  first mixup step (coeff {float(coeff):.4f}, missing {missing}), card against the "
        f"port's f32 on the CPU: fed-back words agree {agree:.4f} (rows whole {rows_same:.4f}; "
        f"bound {FED_BACK_AGREEMENT}), CE relative {ce_rel:.2e} (bound {STYLE_CE_RTOL}), loss "
        f"relative {loss_rel:.2e}, largest gradient difference {grad:.2e} of its largest "
        f"entry; style loss card {float(mk['style_loss']):.6f}, CPU {float(mp['style_loss']):.6f}")
    require(agree >= FED_BACK_AGREEMENT, f"the first mixup step's fed-back words agree on {agree}")
    require(ce_rel <= STYLE_CE_RTOL, f"the first mixup step's CE: relative {ce_rel}")
    if agree == 1.0:
        require(loss_rel <= STYLE_LOSS_RTOL, f"the first mixup step's loss: relative {loss_rel}")
        require(grad <= STYLE_GRAD_SHARE, f"the first mixup step's gradients: {grad}")
    return {"agree": agree, "ce_rel": ce_rel, "loss_rel": loss_rel, "grad": grad}


def caption_ids(path: str) -> np.ndarray:
    """The first CLI_BATCH captions of a factual caption file as ids
    [CLI_BATCH, T_CAP], 0-padded."""
    vocab = synthetic_vocab()
    with open(path) as f:
        lines = [line.split("\t", 1)[1] for line, _ in zip(f, range(CLI_BATCH))]
    ids = np.zeros((len(lines), T_CAP), np.int32)
    for i, line in enumerate(lines):
        enc = vocab.encode(line)[:T_CAP]
        ids[i, :len(enc)] = enc
    return ids


def check_bert_probe(path: str, ids: np.ndarray) -> float:
    """The BERT probe's class probabilities on the card against the port's
    f32 on the CPU, on the same saved weights: on caption ids (hard) and on
    seeded token distributions (soft, as the style losses feed it)."""
    with open(path, "rb") as f:
        saved = pickle.load(f)
    V = saved["bert"]["word_emb"].shape[0]
    soft = torch.softmax(torch.randn((len(ids), T_CAP, V), generator=gen(22)) * 4, dim=-1)
    probs = {"hard": [], "soft": []}
    for dev in (DEVICE, "cpu"):
        params = from_jax_params(saved, dev)
        t = torch.from_numpy(ids).to(dev)
        with torch.no_grad():
            probs["hard"].append(style_classifier_apply(params, t, (t != 0).float()).cpu())
            probs["soft"].append(style_classifier_apply_soft(params, soft.to(dev)).cpu())
    err = {k: (a - b).abs().max().item() for k, (a, b) in probs.items()}
    spread = probs["hard"][1].max(dim=-1).values
    hidden, layers = saved["bert"]["word_emb"].shape[1], len(saved["bert"]["encoder"])
    say(f"  BERT probe (hidden {hidden}, {layers} layers, {max(hidden // 64, 1)} heads) on "
        f"{len(ids)} captions: class probabilities on the card against the CPU's f32, max abs "
        f"difference {err['hard']:.2e} on ids, {err['soft']:.2e} on soft tokens (bound "
        f"{BERT_PROB_TOL}); the CPU's top probability {spread.min():.4f}-{spread.max():.4f} "
        f"[{CARD}]")
    require(max(err.values()) <= BERT_PROB_TOL, f"the BERT probe's probabilities differ: {err}")
    return max(err.values())


def step_parts(state, tx, loss_fn, what: str) -> None:
    """One train step's parts on the host clock, a sync after each (the
    loss forward, its backward, the optimizer), after one warm-up step; and
    the card's busy share of a step (a torch.profiler trace)."""
    def run():
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(state.params)]
        t = [time.perf_counter()]
        loss = loss_fn(tree_unflatten(state.params, leaves))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        state.apply_gradients(tree_unflatten(state.params, grads), tx)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    run()
    fwd, bwd, opt = run()
    wall = fwd + bwd + opt
    busy = kernel_busy_ms(run)
    share = (f"card busy {busy:.2f} ms a step" if busy > 0
             else "card busy time not measured (no device time traced)")
    say(f"  {what}: loss forward {fwd:.2f} ms, backward {bwd:.2f}, optimizer {opt:.2f} (host "
        f"clock, a sync after each; {wall:.2f} ms in all); {share} [{CARD}]")


QUEUED_STEPS = 8


def queued_steps(trainer, state, batch, what: str) -> dict:
    """QUEUED_STEPS style steps issued back to back with one wait at the
    end, ms a step: through the harness's ``DrawingStep`` (the step number
    counted on the host), and with ``int(state.step)`` read before each
    step (a wait for the card, as a draw from the card's counter takes).
    Each twice, in the order read, host, host, read, after a warm-up."""
    step, seed = trainer.style_step, trainer.config.seed

    def host_counted(s):
        draw = harness.DrawingStep(step, seed)
        for _ in range(QUEUED_STEPS):
            s, _ = draw(s, batch)

    def read_each(s):
        for _ in range(QUEUED_STEPS):
            s, _ = step(s, batch, harness.step_generator(seed, int(s.step)))

    host_counted(state)
    ms = {"read": [], "host": []}
    for name, fn in (("read", read_each), ("host", host_counted), ("host", host_counted),
                     ("read", read_each)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(state)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / QUEUED_STEPS)
    say(f"  {what}, {QUEUED_STEPS} steps queued back to back: "
        + ", ".join(f"{x:.2f}" for x in ms["host"]) + " ms a step with the step counted on "
        "the host, " + ", ".join(f"{x:.2f}" for x in ms["read"])
        + f" with state.step read before each [{CARD}]")
    return ms


def style_run(flags: list, name: str, clf: str, extra: list, ckdir: str) -> dict:
    """train_hypernet with a style loss (SpyTrainer's readings): every
    step's loss finite, K4 in the cold featurizes, no K3 launch."""
    SpyTrainer.record = rec = {}
    reset_cli_counts()
    t0 = time.perf_counter()
    hist = cli_hypernet.main(flags + ["--checkpoint-dir", ckdir, "--style-classifier", clf,
                                      "--max-epochs", str(STYLE_EPOCHS[name]), "--log-every",
                                      "1", "--run-name", name, *extra])
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    logs = [r for r in logged(os.path.join(ckdir, f"{name}.jsonl")) if "style_loss" in r]
    require(len(logs) == len(rec["steps"]) > 0 and all(
        np.isfinite([r["train_loss"], r["ce_loss"], r["style_loss"]]).all() for r in logs),
        f"{name}: logged losses {logs}")
    require(all(np.isfinite(h["train_loss_epoch"]) for h in hist.values()), f"{name}: {hist}")
    fit = rec["fit_counts"]
    k3 = {op.name: fit[op.name] for op in tk.KERNELS}
    require(not any(k3.values()), f"{name}: K3 launched in its fit: {k3}")
    cold = [f for f in rec["featurize"] if f["train_step"] is not None
            and f["train_step"] < len(rec["steps"]) // STYLE_EPOCHS[name]]
    require(cold and all(f["k4"] > 0 for f in cold), f"{name}: a cold batch ran no K4")
    require(sum(fit[op.name] for op in ck.KERNELS) > 0, f"{name}: no K4 launch in its fit")
    rec["step_ms"] = float(np.median(rec["steps"][1:]))
    rec["losses"] = logs
    say(f"  train_hypernet {' '.join(extra)} ({STYLE_EPOCHS[name]} epochs, {len(logs)} steps): "
        f"{rec['step_ms']:.2f} ms per train step (median of steps 2-{len(logs)}; first "
        f"{rec['steps'][0]:.1f} ms), the run {rec['seconds']:.2f} s; first/last loss "
        f"{logs[0]['train_loss']:.4f}/{logs[-1]['train_loss']:.4f} (CE {logs[-1]['ce_loss']:.4f}, "
        f"style {logs[-1]['style_loss']:.4f}); launches during fit "
        + ", ".join(f"{k} {v}" for k, v in fit.items()) + f" [{CARD}]")
    return rec


def style_losses() -> dict:
    """(22) The style classifiers and the style losses as a user runs them,
    at full width on phase 20's corpus: train_classifier --kind small and
    --kind style3 (BERT-base), then train_hypernet --mixup on the small
    probe, --style-aux on the BERT probe and --mixup --mixup-split.  ->
    K4's launches during the three fits, by chain width."""
    t_phase = time.perf_counter()
    by_width: dict = {}
    with tempfile.TemporaryDirectory(prefix="captionax-style-") as tmp, cli_spies({}, []):
        data = cli_corpus(tmp) + ["--synthetic-images", str(CLI_IMAGES)]
        small, bert = os.path.join(tmp, "small.pkl"), os.path.join(tmp, "bert.pkl")
        clf_flags = data + ["--checkpoint-dir", os.path.join(tmp, "clf"), "--max-epochs", "1"]
        acc_s, ms_s, n_s, run_s = train_probe(clf_flags, "small", small)
        say(f"  train_classifier --kind small (E={E}, B={CLI_BATCH}): {ms_s:.3f} ms per step "
            f"({n_s} steps), held-out accuracy {acc_s:.4f}, the run {run_s:.2f} s [{CARD}]")
        acc_b, ms_b, n_b, run_b = train_probe(clf_flags, "style3", bert, ("--lr", str(BERT_LR)))
        say(f"  train_classifier --kind style3 (BERT-base, B={CLI_BATCH}, T={T_CAP}, lr "
            f"{BERT_LR}): {ms_b:.2f} ms per step ({n_b} steps), held-out accuracy {acc_b:.4f}, "
            f"the run {run_b:.2f} s [{CARD}]")
        ids = caption_ids(data[data.index("--factual-captions") + 1])
        check_bert_probe(bert, ids)
        with open(bert, "rb") as f:
            tx = make_optimizer(BERT_LR)
            state = create_train_state(from_jax_params(pickle.load(f), DEVICE), tx, device=DEVICE)
        t_ids = torch.from_numpy(ids).to(DEVICE)
        labels = torch.arange(len(ids), device=DEVICE) % 3
        step_parts(state, tx, lambda p: cli_classifier._nll(
            style_classifier_apply(p, t_ids, (t_ids != 0).float()), labels),
            f"a BERT-base classifier step (B={len(ids)})")
        del state
        flags = data + ["--cache-features-device"]
        runs = {}
        runs["mixup"] = style_run(flags, "mixup", small, ["--mixup"], os.path.join(tmp, "mix"))
        mix, (state0, batch0) = runs["mixup"]["trainer"], runs["mixup"]["first"][:2]
        first = check_first_mixup_step(mix, state0, batch0)
        draws = mix.style_step.draws(harness.step_generator(mix.config.seed, int(state0.step)))
        step_parts(state0, mix.tx, lambda p: mix.style_step.loss(p, batch0, *draws)[0],
                   f"a mixup step (small probe, B={CLI_BATCH})")
        queued_steps(mix, state0, batch0, f"mixup (small probe, B={CLI_BATCH})")
        runs["style_aux"] = style_run(flags, "style_aux", bert, ["--style-aux"],
                                      os.path.join(tmp, "aux"))
        aux, (state0, batch0) = runs["style_aux"]["trainer"], runs["style_aux"]["first"][:2]
        step_parts(state0, aux.tx, lambda p: aux.style_step.loss(p, batch0)[0],
                   f"a style-aux step (BERT-base probe, B={CLI_BATCH})")
        queued_steps(aux, state0, batch0, f"style-aux (BERT-base probe, B={CLI_BATCH})")
        runs["mixup_split"] = style_run(flags, "mixup_split", small, ["--mixup", "--mixup-split"],
                                        os.path.join(tmp, "split"))
        for rec in runs.values():
            for w, n in rec["fit_by_width"].items():
                by_width[w] = by_width.get(w, 0) + n
    seconds = time.perf_counter() - t_phase
    say(f"  phase 22 times: small classifier {ms_s:.3f} ms a step, BERT classifier {ms_b:.2f}, "
        f"mixup {runs['mixup']['step_ms']:.2f}, style-aux (BERT probe) "
        f"{runs['style_aux']['step_ms']:.2f}, mixup split {runs['mixup_split']['step_ms']:.2f} "
        f"(B={CLI_BATCH}, T={T_CAP}); the phase {seconds:.2f} s [{CARD}]")
    return {"by_width": by_width, "first": first}


# ------------------------------------------------------------------ 23: Conceptual Captions, zero-shot
# 40 training domains of 12 captions (8 train, 2 val, 2 test each: a domain
# is one batch of 64 a train epoch, its 8 rows resampled to fill it), 10
# unseen domains of 8; image sides 96-480, as phase 21's files.  The
# reference has ~100 domains: at 100 (64-160 px files) the phase took 204 s
# on the card, and at 50 the 96-480 px files took cc_train_hypernet's run
# from 31 s to ~60 s (the loader's PIL decodes and host resizes, 64 a train
# step, in both epochs; a val and a test batch a domain in every run), so
# the count is cut to keep the phase near two minutes
CC_DOMAINS = 40
CC_EPOCHS = 2
CC_SCHEME = "histograme log"
CC_SCHEMES = ("one hot", "embedding", "histograme", "histograme log", "histograme tfidf", "JSD")
CC_LOSS_RTOL = 1e-4    # a scheme's first step on the card against the same step on the CPU
CC_GRAD_SHARE = 1e-3   # of each gradient's largest entry (share_of)
CC_DIRECT_SHARE = 0.99  # test_zero_shot's rows equal to a direct decode, as phase 20 judges
CC_PROBE_SEED = 24
CC_INIT_STEPS = 200
CC_MODS = (cli_cc_hypernet, cli_zero_shot, cli_combine, cli_test_all, cli_cc_gru, cli_train_cc,
           cli_hypernet)
CC_SEARCHES: list = []  # cli_spies' record of test_beam's decodes in phase 23


def cc_loss(params, batch, embed_fn, fused: bool) -> torch.Tensor:
    """The CC hypernet's train loss: the domain's theta, then the
    teacher-forced CE (on K3 when ``fused``; the plain version on the CPU)."""
    theta = hypernet_apply(params["hn"], embed_fn(params, batch))
    return tsteps._tf_ce(params["decoder"], batch, 0, gru_params=theta, fused=fused)


def cli_times(rec: dict, what: str) -> str:
    """A SpyTrainer run's ms a train step, images/s (a synced step's, and
    fit's end to end: the loader and validation in it), featurize and
    test_beam."""
    steps = rec["steps"]
    step_ms = float(np.median(steps[1:] or steps))
    feats = [f for f in rec["featurize"] if f["train_step"] is not None]
    cold = [f["ms"] for f in feats if f["k4"] > 0]
    warm = [f["ms"] for f in feats if f["k4"] == 0]
    beam_ms, batches = sum(rec["test_beam"]), len(rec["searches"])
    return (f"  {what} times: {step_ms:.2f} ms per train step (median of {len(steps)}; first "
            f"{steps[0]:.1f} ms), {CLI_BATCH / step_ms * 1e3:.1f} images/s; featurize cold "
            f"{np.median(cold) if cold else float('nan'):.2f} ms per batch of {CLI_BATCH} "
            f"({len(cold)}), warm {np.median(warm) if warm else float('nan'):.3f} ms "
            f"({len(warm)}); test_beam {beam_ms:.1f} ms over {batches} batches "
            f"({beam_ms / max(batches, 1):.2f} ms a batch); fit {rec['fit_seconds']:.2f} s, "
            f"{len(steps) * CLI_BATCH / rec['fit_seconds']:.1f} train images/s end to end; "
            f"the run {rec['seconds']:.2f} s [{CARD}]")


def cc_cli(main, argv: list) -> tuple:
    """A CLI under SpyTrainer with the launch counts reset, its test
    decodes kept (``rec["searches"]``) -> (its return value, the
    SpyTrainer record)."""
    SpyTrainer.record = rec = {}
    reset_cli_counts()
    CC_SEARCHES.clear()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["searches"] = list(CC_SEARCHES)
    return out, rec


def cc_train(flags: list, ckdir: str, n_domains: int) -> dict:
    """(23.1) cc_train_hypernet on the image files: K3 and K4 in fit, no
    encoder in the warm epoch, finite losses, the first step's loss against
    the per-step loop's."""
    hist, rec = cc_cli(cli_cc_hypernet.main, flags + [
        "--checkpoint-dir", ckdir, "--domain-scheme", CC_SCHEME, "--fused-scan",
        "--cache-features-device", "--max-epochs", str(CC_EPOCHS), "--log-every", "1",
        "--run-name", "phase23"])
    fit = rec["fit_counts"]
    say(f"  cc_train_hypernet --domain-scheme {CC_SCHEME!r}, {n_domains} domains, image files, "
        f"B={CLI_BATCH}, {CC_EPOCHS} epochs, --fused-scan --cache-features-device: launches "
        "during fit " + ", ".join(f"{k} {v}" for k, v in fit.items())
        + "; K4 by chain width " + str(rec["fit_by_width"]))
    for op in tk.KERNELS + ck.KERNELS:
        require(fit[op.name] > 0, f"{op.name} was not launched during cc_train_hypernet's fit")
    steps = rec["steps"]
    require(len(steps) == CC_EPOCHS * n_domains, f"{len(steps)} train steps")
    feats = [f for f in rec["featurize"] if f["train_step"] is not None]
    cold = [f for f in feats if f["train_step"] < n_domains]
    warm = [f for f in feats if f["train_step"] >= n_domains]
    require(len(warm) == n_domains and all(f["k4"] == 0 for f in warm),
            "the encoder ran in epoch 2: " + str([f["k4"] for f in warm if f["k4"]]))
    require(all(f["k4"] > 0 for f in cold), "a cold batch did not run the encoder")
    losses = [r["train_loss"] for r in logged(os.path.join(ckdir, "phase23.jsonl"))
              if "train_loss" in r]
    require(len(losses) == len(steps) and all(np.isfinite(losses)),
            f"logged train losses: {losses[:8]}")
    require(all(np.isfinite(h["train_loss_epoch"]) and np.isfinite(h["val_loss_tf"])
                for h in hist.values()), f"epoch metrics: {hist}")
    trainer = rec["trainer"]
    state0, batch0, loss0 = rec["first"]
    loop, _ = make_hypernet_steps(trainer.tx, embed_fn=trainer._embed_fn, fused_scan=False)
    loop_loss = float(loop(state0, batch0)[1]["train_loss"])
    rel = abs(float(loss0) - loop_loss) / abs(loop_loss)
    say(f"  first step: K3 loss {float(loss0):.6f}, per-step loop {loop_loss:.6f}, relative "
        f"difference {rel:.2e} (bound {TRAIN_LOSS_RTOL}); train loss epoch 1 "
        f"{hist[0]['train_loss_epoch']:.4f}, epoch {CC_EPOCHS} "
        f"{hist[CC_EPOCHS - 1]['train_loss_epoch']:.4f}")
    require(rel <= TRAIN_LOSS_RTOL, "cc_train_hypernet's first K3 step differs from the loop's")
    say(cli_times(rec, "cc_train_hypernet"))
    return rec


def cc_zero_shot_test(flags: list, ckdir: str, corpus: dict, vocab) -> dict:
    """(23.2) test_zero_shot on run 1's checkpoint over the unseen domains:
    finite metrics, captions completed, and the first two unseen domains'
    tokens against a direct decode under their own theta."""
    res, rec = cc_cli(cli_zero_shot.main, flags + [
        "--checkpoint-dir", ckdir, "--domain-scheme", CC_SCHEME, "--synthetic",
        "--run-name", "phase23"])
    searches = rec["searches"]
    require(all(np.isfinite(float(v)) for v in res.values()) and res["beam_completed"] > 0,
            f"test_zero_shot: {res}")
    params = rec["trainer"].params
    embedder = DomainEmbedder(CC_SCHEME, vocab, corpus["domains"], cap_path=corpus["cc"],
                              zero_shot_domains=corpus["zero_shot"],
                              zero_shot_path=corpus["oneshot"])
    order = [b["domain"] for b in ConceptualCaptionsData(
        load_cc_captions(corpus["oneshot"]), vocab).batches(
        CLI_BATCH, seed=0, drop_remainder=False, with_images=False)]
    require(len(order) == len(searches), f"{len(searches)} decodes for {len(order)} batches")
    shares = {}
    with torch.no_grad():
        for dom in corpus["zero_shot"][:2]:
            feats, tokens, found = searches[order.index(dom)]
            value = torch.as_tensor(embedder.host_vector(dom)).to(DEVICE)
            theta = hypernet_apply(params["hn"], embedder.embed(params["domain_emb"], value))
            ref = beam_search(params["decoder"], feats, k=rec["trainer"].config.beam_size,
                              max_steps=rec["trainer"].config.beam_max_steps, gru_params=theta,
                              device=DEVICE)
            shares[dom] = ((ref.tokens == tokens).all(dim=1) & (ref.found == found)).float(
            ).mean().item()
    say(f"  test_zero_shot over {len(corpus['zero_shot'])} unseen domains ({len(order)} "
        f"batches): beam_completed {res['beam_completed']}, beam_bleu1 "
        f"{res.get('beam_bleu1', float('nan')):.4f}, tf_bleu1 {res['tf_bleu1']:.4f}; rows equal "
        "to a direct decode under the domain's own theta: "
        + ", ".join(f"{d} {v:.4f}" for d, v in shares.items())
        + f"; test_beam {sum(rec['test_beam']) / len(searches):.2f} ms a batch [{CARD}]")
    require(all(v >= CC_DIRECT_SHARE for v in shares.values()),
            f"test_zero_shot's tokens against a direct decode: {shares}")
    return res


def cc_schemes(corpus: dict, vocab, batch0) -> dict:
    """(23.3) Each scheme built on the card, then its first train step's
    loss and gradients (K3) against the same step on the CPU, on the same
    weights and batch (run 1's first batch under the first domain)."""
    model_cfg = ModelConfig(vocab_size=len(vocab))
    try:
        import sklearn
        jsd = f"t-SNE (scikit-learn {sklearn.__version__})"
    except ImportError:
        jsd = "classical MDS (no scikit-learn here)"
    say(f"  JSD coordinates on this machine: {jsd}")
    out = {}
    for scheme in CC_SCHEMES:
        data_cfg = DataConfig(cc_captions=corpus["cc"], cc_oneshot_captions=corpus["oneshot"],
                              domain_scheme=scheme)
        t0 = time.perf_counter()
        DomainEmbedder(scheme, vocab, corpus["domains"], cap_path=corpus["cc"])
        tables_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, embedder, embed_fn = cli_cc_hypernet.build_cc_model_and_embedder(
            model_cfg, data_cfg, vocab, gen(23), device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        value = torch.as_tensor(np.asarray(embedder.host_vector(corpus["domains"][0])))
        batch = {"features": batch0["features"], "captions": batch0["captions"],
                 "domain_value": value.to(DEVICE)}
        t0 = time.perf_counter()
        loss_k, grads_k = tsteps._value_and_grad(lambda p: cc_loss(p, batch, embed_fn, True),
                                                 params)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        pc, bc = to_device(params, "cpu"), to_device(batch, "cpu")
        t0 = time.perf_counter()
        loss_c, grads_c = tsteps._value_and_grad(lambda p: cc_loss(p, bc, embed_fn, True), pc)
        cpu_s = time.perf_counter() - t0
        rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
        grad = max(share_of(a, b) for a, b in zip(tree_leaves(grads_k), tree_leaves(grads_c)))
        out[scheme] = {"tables_s": tables_s, "build_s": build_s, "rel": rel, "grad": grad}
        say(f"  {scheme!r} (hyper_emb {embedder.hyper_emb}): host tables {tables_s:.2f} s, the "
            f"model built on the card {build_s:.2f} s; first step loss card {float(loss_k):.6f}, "
            f"CPU {float(loss_c):.6f}, relative {rel:.2e} (bound {CC_LOSS_RTOL}); largest "
            f"gradient difference {grad:.2e} of its largest entry (bound {CC_GRAD_SHARE}); the "
            f"step {card_s:.2f} s on the card (first call), {cpu_s:.2f} s on the CPU [{CARD}]")
        require(rel <= CC_LOSS_RTOL, f"{scheme}: the first step's loss, relative {rel}")
        require(grad <= CC_GRAD_SHARE, f"{scheme}: the first step's gradients, {grad}")
        del params, grads_k, pc, grads_c
    return out


def cc_combine(flags: list, tmp: str, vocab) -> dict:
    """(23.4) train_hyper_combine --domain-scheme "one hot" --style-aux
    --select-sep-margin on phase 20's Flickr corpus and the CC file, then
    test_all on its checkpoint: five finite result sets."""
    probe = os.path.join(tmp, "probe4.pkl")
    with open(probe, "wb") as f:
        pickle.dump(to_numpy_tree(small_style_classifier_init(
            gen(CC_PROBE_SEED), len(vocab), E, 4, device="cpu")), f)
    ckdir = os.path.join(tmp, "combine")
    argv = flags + ["--synthetic-images", str(CLI_IMAGES), "--checkpoint-dir", ckdir,
                    "--domain-scheme", "one hot", "--cache-features-device"]
    hist, rec = cc_cli(cli_combine.main, argv + [
        "--style-aux", "--style-classifier", probe, "--select-sep-margin",
        "--skip-val-quality", "--max-epochs", "1", "--log-every", "1",
        "--run-name", "phase23_combine"])
    logs = [r for r in logged(os.path.join(ckdir, "phase23_combine.jsonl")) if "style_loss" in r]
    require(len(logs) == len(rec["steps"]) > 0 and all(
        np.isfinite([r["train_loss"], r["ce_loss"], r["style_loss"]]).all() for r in logs),
        f"train_hyper_combine: logged losses {logs[:4]}")
    require(all(np.isfinite(h["train_loss_epoch"]) and np.isfinite(h["val_sep_margin"])
                for h in hist.values()), f"train_hyper_combine: {hist}")
    fit = rec["fit_counts"]
    require(sum(fit[op.name] for op in ck.KERNELS) > 0, "train_hyper_combine: no K4 in fit")
    say(f"  train_hyper_combine --style-aux --select-sep-margin (one hot, 4-class small probe): "
        f"{len(logs)} steps, val_sep_margin {hist[0]['val_sep_margin']:.4f}, val_sep_acc "
        f"{hist[0]['val_sep_acc']:.4f}, train loss {hist[0]['train_loss_epoch']:.4f}; launches "
        "during fit " + ", ".join(f"{k} {v}" for k, v in fit.items()))
    say(cli_times(rec, "train_hyper_combine"))
    results, arec = cc_cli(cli_test_all.main, argv + ["--run-name", "phase23"])
    require(list(results) == ["factual", "humour", "romantic", "cc", "cc_zero_shot"]
            and all(np.isfinite(float(v)) for r in results.values() for v in r.values()),
            f"test_all: {results}")
    say("  test_all on its checkpoint: " + "; ".join(
        f"{k} beam_completed {r['beam_completed']}, tf_bleu1 {r['tf_bleu1']:.4f}"
        for k, r in results.items()) + f"; the run {arec['seconds']:.2f} s [{CARD}]")
    return rec


def cc_others(flags: list, corpus: dict, tmp: str) -> None:
    """(23.5) cc_train_gru for an epoch, train_cc without --fetch, and
    train_init then train_hypernet --init-hn on its checkpoint."""
    hist, rec = cc_cli(cli_cc_gru.main, flags + [
        "--checkpoint-dir", os.path.join(tmp, "cc_gru"), "--max-epochs", "1", "--fused-scan",
        "--cache-features-device"])
    require(all(np.isfinite(h["train_loss_epoch"]) for h in hist.values()), f"cc_train_gru: {hist}")
    for op in tk.KERNELS:
        require(rec["fit_counts"][op.name] > 0, f"cc_train_gru: {op.name} not launched")
    say(f"  cc_train_gru --fused-scan: train loss {hist[0]['train_loss_epoch']:.4f}, "
        f"val_loss_tf {hist[0]['val_loss_tf']:.4f}")
    say(cli_times(rec, "cc_train_gru"))
    hist, rec = cc_cli(cli_train_cc.main, flags + [
        "--gcc-tsv", corpus["gcc"], "--checkpoint-dir", os.path.join(tmp, "train_cc"),
        "--max-epochs", "1"])
    require(all(np.isfinite(h["train_loss_epoch"]) for h in hist.values()), f"train_cc: {hist}")
    say(f"  train_cc --gcc-tsv (no --fetch: every image the placeholder), {len(rec['steps'])} "
        f"steps: train loss {hist[0]['train_loss_epoch']:.4f}; the run {rec['seconds']:.2f} s "
        f"[{CARD}]")
    init_dir = os.path.join(tmp, "init")
    t0 = time.perf_counter()
    distilled = cli_init.main(flags + ["--checkpoint-dir", init_dir,
                                       "--max-steps", str(CC_INIT_STEPS)])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    saved = tckpt.restore_checkpoint(init_dir)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(distilled["hn"]),
                                                        tree_leaves(saved["hn"]))),
            "train_init's checkpoint does not hold its hypernet")
    hist, rec = cc_cli(cli_hypernet.main, flags + [
        "--synthetic-images", str(CLI_GRU_IMAGES), "--checkpoint-dir", os.path.join(tmp, "init_hn"),
        "--init-hn", init_dir, "--max-epochs", "1"])
    start = rec["first"][0].params["hn"]
    require(all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(start), tree_leaves(saved["hn"]))),
            "train_hypernet --init-hn did not start from train_init's hypernet")
    require(all(np.isfinite(h["train_loss_epoch"]) for h in hist.values()),
            f"train_hypernet --init-hn: {hist}")
    say(f"  train_init --max-steps {CC_INIT_STEPS}: {init_s:.2f} s; train_hypernet --init-hn "
        f"on its checkpoint starts from its hypernet exactly: train loss "
        f"{hist[0]['train_loss_epoch']:.4f}, the run {rec['seconds']:.2f} s [{CARD}]")


def cc_zero_shot() -> dict:
    """(23) Conceptual Captions and zero-shot transfer as a user runs them,
    at full width on a seeded CC corpus (CC_DOMAINS domains of 12 captions,
    an image file each; 10 unseen domains of 8): cc_train_hypernet on the files (K3,
    K4), test_zero_shot, each scheme's first step on the card against the
    CPU, train_hyper_combine --style-aux --select-sep-margin then test_all,
    cc_train_gru, train_cc and train_init -> train_hypernet --init-hn.  ->
    K3's and K4's launches during cc_train_hypernet's fit."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="captionax-cc-") as tmp, \
            cli_spies({}, CC_SEARCHES, CC_MODS):
        data = cli_corpus(tmp)
        t0 = time.perf_counter()
        corpus = seeded_cc_corpus(tmp, domains=CC_DOMAINS)
        say(f"  the seeded CC corpus: {len(corpus['domains'])} domains, "
            f"{len(load_cc_captions(corpus['cc']))} captions and image files, "
            f"{len(corpus['zero_shot'])} unseen domains, written in "
            f"{time.perf_counter() - t0:.2f} s")
        vocab = load_vocab_pickle(data[data.index("--vocab-path") + 1])
        cc = ["--cc-captions", corpus["cc"], "--cc-oneshot-captions", corpus["oneshot"]]
        files = [f for f in data if f != "--synthetic"] + cc  # images from the files
        synthetic = data + cc
        ckdir = os.path.join(tmp, "cc_hypernet")
        rec = cc_train(files, ckdir, len(corpus["domains"]))
        cc_zero_shot_test(files, ckdir, corpus, vocab)
        cc_schemes(corpus, vocab, rec["first"][1])
        cc_combine(synthetic, tmp, vocab)
        cc_others(synthetic, corpus, tmp)
    say(f"  the CC phase: {time.perf_counter() - t_phase:.2f} s [{CARD}]")
    return {"counts": rec["fit_counts"], "by_width": rec["fit_by_width"]}


# ------------------------------------------------------------------ 24: the cell and LSTM captioners
# train_captioning at the CLI defaults is the v0 hypernet captioner at
# E = H = 200: 3.657 B parameters, 58.5 GB with gradients and Adam's two
# moments.  Its LSTM at H = 200 (6.474 B, 103.6 GB) fits no single card, so
# the LSTM runs at H = 150 (2.863 B, 45.8 GB).  --tf-decay 0.5 brings
# sampled steps into the one epoch (seed 0's draws: TF, TF, then sampled).
CAP_TF_DECAY = "0.5"
CAP_LSTM_H = 150
CAP_LSTM_IMAGES = 240   # three train batches of 64: TF, TF, sampled
CAP_SMALL = 32          # E = H of the card-against-CPU steps, at V = 9684
CAP_LOSS_RTOL = 1e-4    # phase 22's bounds
CAP_GRAD_SHARE = 1e-3
LSTM_IDS_AGREEMENT = 0.99


def k4_counts() -> tuple:
    return (sum(op.launches for op in ck.KERNELS), dict(ck.LAUNCHES_BY_WIDTH))


def k4_since(before: tuple) -> tuple:
    n, widths = k4_counts()
    return n - before[0], {w: c - before[1].get(w, 0) for w, c in widths.items()}


@contextlib.contextmanager
def patched(mod, **fns):
    """``mod``'s attributes replaced for the block, then put back."""
    old = {k: getattr(mod, k) for k in fns}
    for k, v in fns.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def held_tensors(min_bytes: int = 10 ** 8) -> str:
    """The live card tensors of at least ``min_bytes``, largest first (what
    an earlier phase left behind)."""
    big = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            if st.nbytes() >= min_bytes:
                big[st.data_ptr()] = (st.nbytes(), tuple(o.shape))
    if not big:
        return ""
    top = sorted(big.values(), reverse=True)
    return (f"; {len(top)} tensors of over {min_bytes / 1e9:.1f} GB hold "
            f"{sum(n for n, _ in top) / 1e9:.2f} GB, the largest "
            + ", ".join(f"{list(shape)} {n / 1e9:.2f} GB" for n, shape in top[:6]))


def synced_ms(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def captioning_run(flags: list, what: str) -> dict:
    """train_captioning as a user runs it, with its model build, train
    state and steps timed (a sync around each), fc_out kept at its init
    and K4's launches counted.  -> the record."""
    rec = {"steps": []}
    build, state_of, make_step = (cli_captioning.build_capgru_model,
                                  cli_captioning.create_train_state,
                                  cli_captioning.make_train_step)

    def timed_build(*args, **kwargs):
        params, rec["build_ms"] = synced_ms(lambda: build(*args, **kwargs))
        rec["params"] = count_params(params)
        rec["fc_out"] = {k: v.detach().cpu().clone()
                         for k, v in params["decoder"]["fc_out"].items()}
        return params

    def timed_state(*args, **kwargs):
        state, rec["state_ms"] = synced_ms(lambda: state_of(*args, **kwargs))
        return state

    def timed_make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(state, feats, caps, style, teacher_forcing, h0, gumbel):
            (new, loss), ms = synced_ms(step, state, feats, caps, style, teacher_forcing,
                                        h0, gumbel)
            rec["steps"].append((teacher_forcing, ms, float(loss)))
            return new, loss
        return timed

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = k4_counts()
    t0 = time.perf_counter()
    with patched(cli_captioning, build_capgru_model=timed_build,
                 create_train_state=timed_state, make_train_step=timed_make):
        state = cli_captioning.main(flags)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["k4"], rec["by_width"] = k4_since(before)
    total = torch.cuda.get_device_properties(0).total_memory
    steps = rec["steps"]
    tf_ms = [ms for tf, ms, _ in steps if tf]
    sampled_ms = [ms for tf, ms, _ in steps if not tf]
    fc = state.params["decoder"]["fc_out"]
    same_fc = all(torch.equal(fc[k].cpu(), rec["fc_out"][k]) for k in fc)
    B = int(flags[flags.index("--batch-size") + 1])
    say(f"  {what}: {rec['params']:,} parameters; the model drawn on the host and uploaded "
        f"leaf by leaf {rec['build_ms'] / 1e3:.2f} s, the train state (Adam's moments on the "
        f"card) {rec['state_ms'] / 1e3:.2f} s; {len(steps)} steps ({len(tf_ms)} teacher-forced, "
        f"{len(sampled_ms)} sampled): {np.median(tf_ms) if tf_ms else float('nan'):.1f} ms per "
        f"TF step, {np.median(sampled_ms) if sampled_ms else float('nan'):.1f} ms per sampled "
        f"step (median; a sync before and after), "
        f"{B * len(steps) / (sum(tf_ms) + sum(sampled_ms)) * 1e3:.1f} images/s in the steps, "
        f"{B * len(steps) / rec['seconds']:.1f} over the run ({rec['seconds']:.2f} s, the build "
        "and the encoder in it); each step " + ", ".join(
            f"{'TF' if tf else 'sampled'} {ms:.1f} ms (loss {l:.4f})" for tf, ms, l in steps)
        + f"; peak card memory {rec['peak'] / 1e9:.2f} GB of {total / 1e9:.2f} GB; K4 launches "
        f"{rec['k4']}; fc_out bit-equal to its init: {same_fc} [{CARD}]")
    require(all(np.isfinite(l) for *_, l in steps), f"{what}: a loss is not finite")
    require(tf_ms and sampled_ms, f"{what}: the run did not both teacher-force and sample")
    require(same_fc, f"{what}: fc_out moved")
    require(rec["peak"] < total, f"{what}: peak memory {rec['peak']} of {total}")
    require(rec["k4"] > 0, f"{what}: K4 did not launch")
    del state
    torch.cuda.empty_cache()
    return rec


def capgru_step_on(params, feats, caps, style, cell, tf, h0, gumbel, device):
    p = to_device(params, device)
    args = [None if x is None else x.to(device) for x in (feats, caps, style, h0, gumbel)]
    return tsteps._value_and_grad(lambda q: cli_captioning.capgru_loss(
        q, args[0], args[1], args[2], cell=cell, teacher_forcing=tf, pad_id=None,
        h0=args[3], gumbel=args[4]), p)


def captioning_card_vs_cpu(V: int) -> None:
    """The first TF step and the first sampled step of capgru_loss at
    E = H = CAP_SMALL, V = 9684, B = 64, on the card and on the CPU, from
    the same weights and draws: GRU and LSTM, 1 and 2 layers."""
    rs = np.random.RandomState(24)
    B, T = CLI_BATCH, T_CAP
    feats = torch.from_numpy(np.abs(rs.randn(B, 2048)).astype(np.float32))
    caps = torch.from_numpy(rs.randint(0, V, (B, T)))
    style = torch.tensor(STYLE)
    worst = {}
    for cell in ("gru", "lstm"):
        for layers in (1, 2):
            params = cli_captioning.build_capgru_model(gen(24 + layers), CAP_SMALL, CAP_SMALL,
                                                       V, cell, layers, device="cpu")
            g = gen(240 + layers)
            h0 = torch.rand((B, CAP_SMALL), generator=g) if cell == "gru" else None
            noise = gumbel_noise(g, (T, B, V), "cpu")
            for tf in (True, False):
                gum = None if tf else noise
                loss_k, grads_k = capgru_step_on(params, feats, caps, style, cell, tf, h0,
                                                 gum, DEVICE)
                loss_c, grads_c = capgru_step_on(params, feats, caps, style, cell, tf, h0,
                                                 gum, "cpu")
                rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
                grad = max(share_of(a, b) for a, b in zip(tree_leaves(grads_k),
                                                          tree_leaves(grads_c)))
                name = f"{cell} {layers} layer{'s' if layers > 1 else ''} {'TF' if tf else 'sampled'}"
                worst[name] = (float(loss_k), float(loss_c), rel, grad)
                require(rel <= CAP_LOSS_RTOL, f"capgru_loss {name}: loss relative {rel}")
                require(grad <= CAP_GRAD_SHARE, f"capgru_loss {name}: gradients {grad}")
    say(f"  capgru_loss's first step, card against CPU (E = H = {CAP_SMALL}, V = {V}, B = {B}, "
        f"T = {T}; loss bound {CAP_LOSS_RTOL} relative, gradients {CAP_GRAD_SHARE} of their "
        "largest entry): " + "; ".join(
            f"{k}: loss {a:.6f} / {b:.6f}, relative {r:.2e}, gradients {g:.2e}"
            for k, (a, b, r, g) in worst.items()))


def lstm_run(flags: list, variant: str, tmp: str) -> dict:
    """train_lstm --variant ``variant`` for an epoch and its validation;
    its first step and first greedy decode held against the CPU on the same
    weights and inputs; the checkpoint restored."""
    rec = {"steps": []}
    make_step = cli_lstm.make_train_step
    decodes = {"lstm_greedy": cli_lstm.lstm_greedy,
               "show_attend_tell_sample": cli_lstm.show_attend_tell_sample}

    def timed_make(forward, tx):
        step = make_step(forward, tx)
        rec["forward"] = forward

        def timed(state, batch):
            if "first" not in rec:  # the step writes the state in place: keep a copy
                rec["first"] = (to_device(state.params, "cpu"), to_device(batch, "cpu"))
            (new, loss), ms = synced_ms(step, state, batch)
            rec["steps"].append((ms, float(loss)))
            return new, loss
        return timed

    def kept(name):
        def decode(params, feats, **kw):
            ids = decodes[name](params, feats, **kw)
            rec.setdefault("decode", (name, to_device(params, "cpu"), feats.cpu(), kw,
                                      ids.cpu()))
            return ids
        return decode

    ckdir = os.path.join(tmp, f"lstm_{variant}")
    before = k4_counts()
    t0 = time.perf_counter()
    with patched(cli_lstm, make_train_step=timed_make,
                 **{name: kept(name) for name in decodes}):
        state, results = cli_lstm.main(flags + [
            "--variant", variant, "--max-epochs", "1", "--cache-features-device",
            "--checkpoint-dir", ckdir, "--run-name", f"phase24_{variant}"])
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["k4"], rec["by_width"] = k4_since(before)
    losses = [l for _, l in rec["steps"]]
    require(losses and all(np.isfinite(losses)), f"train_lstm {variant}: losses {losses}")
    require(all(np.isfinite(float(v)) for v in results.values()),
            f"train_lstm {variant}: validation {results}")
    require(rec["k4"] > 0, f"train_lstm {variant}: K4 did not launch")
    # the first step on the card against the CPU
    params0, batch0 = rec["first"]
    forward = rec["forward"]

    def loss_grads(params, batch):
        return tsteps._value_and_grad(
            lambda p: cross_entropy_loss(*forward(p, batch)), params)

    loss_k, grads_k = loss_grads(to_device(params0, DEVICE), to_device(batch0, DEVICE))
    loss_c, grads_c = loss_grads(params0, batch0)
    rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    grad = max(share_of(a, b) for a, b in zip(tree_leaves(grads_k), tree_leaves(grads_c)))
    require(rel <= CAP_LOSS_RTOL, f"train_lstm {variant}: first loss relative {rel}")
    require(grad <= CAP_GRAD_SHARE, f"train_lstm {variant}: first gradients {grad}")
    agree = None
    if variant in ("attention", "sat"):
        name, p_cpu, f_cpu, kw, ids_k = rec["decode"]
        with torch.no_grad():
            ids_c = decodes[name](p_cpu, f_cpu, **kw)
        agree = (ids_k == ids_c).all(dim=1).float().mean().item()
        require(agree >= LSTM_IDS_AGREEMENT, f"train_lstm {variant}: {name} rows {agree}")
    saved = tckpt.restore_checkpoint(ckdir)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(state.params),
                                                        tree_leaves(saved))),
            f"train_lstm {variant}: the checkpoint does not restore the parameters")
    ms = [m for m, _ in rec["steps"]]
    B = CLI_BATCH
    say(f"  train_lstm --variant {variant} (E = H = 200, ResNet-152 on K4, "
        f"--cache-features-device): {len(ms)} steps, {np.median(ms):.2f} ms per step (median; "
        f"first {ms[0]:.1f} ms), {B / np.median(ms) * 1e3:.1f} images/s in the steps, the run "
        f"{rec['seconds']:.2f} s; first step card against CPU: loss {float(loss_k):.6f} / "
        f"{float(loss_c):.6f}, relative {rel:.2e}, gradients {grad:.2e}; val_loss_tf "
        f"{results['val_loss_tf']:.4f}, tf_bleu1 {results['tf_bleu1']:.4f}"
        + ("" if agree is None else f", greedy_bleu1 {results['greedy_bleu1']:.4f}; greedy "
           f"rows equal to the CPU's {agree:.4f}")
        + f"; K4 launches {rec['k4']}; the checkpoint restores exactly [{CARD}]")
    del state
    return rec


def cell_lstm_captioners() -> dict:
    """(24) The cell and LSTM captioners as a user runs them, on phase 20's
    corpus: train_captioning --cell gru at the CLI defaults (3.657 B
    parameters) for an epoch, --cell lstm at H = 150 for three steps,
    capgru_loss's first steps card against CPU at E = H = 32, and
    train_lstm's four variants at full width.  -> K4's launches in the
    phase's runs, by chain width."""
    t_phase = time.perf_counter()
    by_width: dict = {}
    with tempfile.TemporaryDirectory(prefix="captionax-cells-") as tmp:
        data = cli_corpus(tmp)
        vocab = load_vocab_pickle(data[data.index("--vocab-path") + 1])
        base = data + ["--max-epochs", "1", "--tf-decay", CAP_TF_DECAY, "--log-every", "1"]
        say(f"  card memory held before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB"
            + held_tensors())
        runs = [captioning_run(base + [
            "--synthetic-images", str(CLI_IMAGES), "--cell", "gru",
            "--checkpoint-dir", os.path.join(tmp, "cap_gru"), "--run-name", "phase24_gru"],
            "train_captioning --cell gru (E = H = 200, V = 9684, one layer, B = 64)")]
        runs.append(captioning_run(base + [
            "--synthetic-images", str(CAP_LSTM_IMAGES), "--cell", "lstm",
            "--hidden-size", str(CAP_LSTM_H), "--checkpoint-dir", os.path.join(tmp, "cap_lstm"),
            "--run-name", "phase24_lstm"],
            f"train_captioning --cell lstm (E = 200, H = {CAP_LSTM_H}, V = 9684, B = 64)"))
        captioning_card_vs_cpu(len(vocab))
        flags = data + ["--synthetic-images", str(CLI_IMAGES), "--log-every", "1"]
        runs += [lstm_run(flags, v, tmp) for v in cli_lstm.VARIANTS]
        for rec in runs:
            for w, n in rec["by_width"].items():
                by_width[w] = by_width.get(w, 0) + n
    say(f"  phase 24: {time.perf_counter() - t_phase:.2f} s [{CARD}]")
    return {"by_width": by_width}


# ------------------------------------------------------------------ 25: the transformer captioners
# train_labert and train_catr at their CLI defaults: LaBERT at hidden 768,
# 12 layers, 12 heads, FFN 3072 over V = 9684 + [MASK] (106.7 M
# parameters, 49 + 25 tokens a row), CATR at hidden 256, 8 heads, FFN
# 2048, 6 + 6 layers (25.8 M).  Their ResNet-152 is k4_resnet's (every
# folded scale and bias drawn), so the K4 check on the CLI's own batch sees
# every conv.
TR_SMALL = 64            # hidden of the card-against-CPU steps, 2 layers a side, at V = 9684
TR_SMALL_HEADS = 2       # LaBERT's decode runs hidden // 64 = 1 head, as captionax's
TR_SMALL_LAYERS = 2
TR_DECODE_BATCHES = 2    # the card-against-CPU decodes run on the first two batches' features
TR_IDS_AGREEMENT = 0.99  # rows of ids equal, card against CPU (near ties)
TR_MASK_LENGTH = 12      # train_labert's mask-predict length


def transformer_run(cli, kind: str, flags: list, what: str, step_loss) -> dict:
    """train_labert or train_catr as a user runs it, on k4_resnet's ResNet,
    with its model build, steps and decodes timed (a sync around each), the
    first step's inputs and the first batches' images and features kept,
    the final metrics recorded and K4's launches counted; then a step on
    the first inputs by part (``step_loss(params, *inputs)``, the step's
    loss).  -> the record."""
    rec = {"steps": [], "feats": [], "decodes": [], "metrics": []}
    build_name = "build_labert_model" if kind == "labert" else "build_catr_model"
    decode_name = "mask_predict_decode" if kind == "labert" else "catr_greedy"
    build, make_step = getattr(cli, build_name), cli.make_train_step
    make_enc, decode, metrics = cli.make_encoder, getattr(cli, decode_name), cli.CaptionMetrics

    def timed_build(*args, **kwargs):
        params, rec["build_ms"] = synced_ms(lambda: build(*args, **kwargs))
        rec["params"] = count_params(params)
        return params

    def spied_encoder(params, regions=True, device=None):
        encode = make_enc(params, regions, device)
        rec["encoder_params"] = params

        def spied(images):
            out = encode(images)
            if len(rec["feats"]) < TR_DECODE_BATCHES:
                rec["feats"].append((images, out.detach().clone()))
            return out
        return spied

    def timed_make(*args, **kwargs):
        step = make_step(*args, **kwargs)
        rec["tx"] = args[0]

        def timed(state, *inputs):
            if "first" not in rec:
                rec["first"] = to_device(list(inputs), "cpu")
            (new, loss), ms = synced_ms(step, state, *inputs)
            rec["steps"].append((ms, float(loss)))
            return new, loss
        return timed

    def timed_decode(*args, **kwargs):
        ids, ms = synced_ms(lambda: decode(*args, **kwargs))
        rec["decodes"].append((ms, tuple(ids.shape)))
        return ids

    class Recorded(metrics):
        def compute(self):
            out = super().compute()
            rec["metrics"].append(out)
            return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = k4_counts()
    t0 = time.perf_counter()
    with patched(cli, **{build_name: timed_build, "build_encoder": lambda *a, **k: k4_resnet(25),
                         "make_encoder": spied_encoder, "make_train_step": timed_make,
                         decode_name: timed_decode, "CaptionMetrics": Recorded}):
        state = cli.main(flags)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["k4"], rec["by_width"] = k4_since(before)
    losses = [l for _, l in rec["steps"]]
    require(losses and all(np.isfinite(losses)), f"{what}: losses {losses}")
    require(rec["decodes"] and rec["metrics"], f"{what}: no validation decode")
    require(all(np.isfinite(v) for v in rec["metrics"][-1].values()),
            f"{what}: metrics {rec['metrics'][-1]}")
    require(rec["k4"] > 0, f"{what}: K4 did not launch")
    require(rec["peak"] < torch.cuda.get_device_properties(0).total_memory,
            f"{what}: peak memory {rec['peak']}")
    ms = [m for m, _ in rec["steps"]]
    warm = ms[1:] or ms
    B = CLI_BATCH
    log = logged(os.path.join(flags[flags.index("--checkpoint-dir") + 1], "run.jsonl"))
    val = [r["val_loss"] for r in log if "val_loss" in r]
    require(all(np.isfinite(val)), f"{what}: val_loss {val}")
    say(f"  {what}: {rec['params']:,} parameters, drawn on the host and uploaded "
        f"{rec['build_ms'] / 1e3:.2f} s; {len(ms)} steps: {np.median(warm):.2f} ms per warm step "
        f"(median of {len(warm)}; first {ms[0]:.1f} ms; a sync before and after), "
        f"{B / np.median(warm) * 1e3:.1f} images/s in the warm steps, the run "
        f"{rec['seconds']:.2f} s (the ResNet-152 on K4 in every batch, the model's build); "
        f"losses " + ", ".join(f"{l:.4f}" for l in losses)
        + (f"; val_loss {val[-1]:.4f}" if val else "")
        + "; decodes " + ", ".join(f"{list(shape)} {m:.1f} ms" for m, shape in rec["decodes"])
        + f"; metrics bleu1 {rec['metrics'][-1]['bleu1']:.4f}; peak card memory "
        f"{rec['peak'] / 1e9:.2f} GB; K4 launches {rec['k4']} [{CARD}]")
    inputs = to_device(rec["first"], DEVICE)
    step_parts(state, rec.pop("tx"), lambda p: step_loss(p, *inputs), f"{what}, a step by part")
    del state, inputs
    return rec


def k4_on_cli_batch(rec: dict, what: str) -> None:
    """The CLI's features of its first batch against CNNEncoder.plain on the
    same images (bf16, the encoder's compute dtype)."""
    images, feats = rec["feats"][0]
    ref = CNNEncoder(rec["encoder_params"], device=DEVICE).plain(
        preprocess_images(images, DEVICE))
    require(feats.shape == ref.shape, f"{what}: {tuple(feats.shape)} {tuple(ref.shape)}")
    require(bool(torch.isfinite(feats).all()), f"{what}: non-finite features")
    rel = rel_err(feats, ref)
    say(f"  {what}: the first batch's features {list(feats.shape)} (K4) against "
        f"CNNEncoder.plain on the same images: max error {rel:.3e} of the largest entry "
        f"{ref.float().abs().max().item():.3f} (bound {K4_FULL_BF16_TOL}) [{CARD}]")
    require(rel <= K4_FULL_BF16_TOL, f"{what}: K4 error {rel} > {K4_FULL_BF16_TOL}")


def card_and_cpu(loss_fn, params, inputs):
    """(loss, gradients) on the card in f32 and on the CPU in f64 and f32,
    from the same weights and inputs -> (card loss, CPU f64 loss, relative,
    worst gradient share against f64, the same against the CPU's f32).
    The CPU's f32 gradients are not the reference: on some leaves they
    stray further from f64 than the card's do (``PERF.md``)."""
    f64 = lambda tree: tree_map(lambda x: x.double() if x.is_floating_point() else x, tree)
    out = {}
    for key, device, cast in (("card", DEVICE, None), ("f64", "cpu", f64), ("f32", "cpu", None)):
        p, args = to_device(params, device), to_device(inputs, device)
        if cast is not None:
            p, args = cast(p), cast(args)
        out[key] = tsteps._value_and_grad(lambda q: loss_fn(q, *args), p)
    (loss_k, grads_k), (loss_r, grads_r) = out["card"], out["f64"]
    rel = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
    grad, worst = max(zip(map(share_of, tree_leaves(grads_k), tree_leaves(grads_r)),
                          leaf_paths(grads_r)))
    grad32 = max(map(share_of, tree_leaves(grads_k), tree_leaves(out["f32"][1])))
    return float(loss_k), float(loss_r), rel, grad, worst, grad32


def leaf_paths(tree, prefix: str = "") -> list:
    """The leaves' paths (``a/b/0/c``) in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def rows_equal(decode, params, feats) -> float:
    """The share of rows whose ids the card and the CPU decode alike."""
    ids_k = decode(to_device(params, DEVICE), feats.to(DEVICE)).cpu()
    ids_c = decode(params, feats)
    return (ids_k == ids_c).all(dim=1).float().mean().item()


def transformers_card_vs_cpu(runs: dict, V: int) -> None:
    """The first train step of LaBERT and of CATR at hidden TR_SMALL, 2
    layers a side, V = 9684, B = 64, on the card (f32) and on the CPU (f64)
    from the same weights and the CLI runs' own first inputs (features,
    captions, LaBERT's types and mask draws); then mask_predict_decode and
    catr_greedy in f32 on the first batches' features, card against CPU."""
    lab, cat = runs["labert"], runs["catr"]
    feats = torch.cat([f for _, f in lab["feats"]]).cpu()
    mask_id = V
    lab_params = cli_labert.build_labert_model(gen(250), V + 1, TR_SMALL, TR_SMALL_LAYERS,
                                               TR_SMALL_HEADS, "cpu")
    cat_params = cli_catr.build_catr_model(gen(251), V, TR_SMALL, TR_SMALL_HEADS,
                                           TR_SMALL_LAYERS, TR_SMALL_LAYERS, "cpu")
    checks = {
        "labert_loss": card_and_cpu(
            lambda p, f, c, t, d: labert_loss(p, f, c, t, d, mask_id, num_heads=TR_SMALL_HEADS),
            lab_params, lab["first"]),
        "catr_forward CE": card_and_cpu(
            lambda p, f, c: cross_entropy_loss(
                catr_forward(p, f, c[:, :-1], num_heads=TR_SMALL_HEADS), c[:, 1:]),
            cat_params, cat["first"]),
    }
    for name, (_, _, rel, grad, _, _) in checks.items():
        require(rel <= CAP_LOSS_RTOL, f"{name}: first loss relative {rel}")
        require(grad <= CAP_GRAD_SHARE, f"{name}: first gradients {grad}")
    with torch.no_grad():
        agree = {
            "mask_predict_decode": rows_equal(
                lambda p, f: mask_predict_decode(p, f, mask_id, length=TR_MASK_LENGTH),
                lab_params, feats),
            "catr_greedy": rows_equal(
                lambda p, f: catr_greedy(p, f, max_len=T_CAP, num_heads=TR_SMALL_HEADS),
                cat_params, feats),
        }
    say(f"  the first train step, card (f32) against CPU (f64) (hidden {TR_SMALL}, "
        f"{TR_SMALL_LAYERS} layers a side, {TR_SMALL_HEADS} heads, V = {V}, B = {CLI_BATCH}, the "
        f"CLI runs' first inputs; loss bound {CAP_LOSS_RTOL} relative, gradients "
        f"{CAP_GRAD_SHARE} of their largest entry): " + "; ".join(
            f"{k}: loss {a:.6f} / {b:.6f}, relative {r:.2e}, gradients {g:.2e} (at {leaf}; "
            f"against the CPU's f32 {g32:.2e})" for k, (a, b, r, g, leaf, g32) in checks.items())
        + f"; decodes on {len(feats)} rows, rows equal to the CPU's: "
        + ", ".join(f"{k} {v:.4f}" for k, v in agree.items()) + f" [{CARD}]")
    for name, share in agree.items():
        require(share >= TR_IDS_AGREEMENT, f"{name}: rows equal {share}")


def transformer_captioners() -> dict:
    """(25) The transformer captioners as a user runs them, on phase 20's
    corpus: train_labert and train_catr at their defaults for an epoch with
    their validation and decodes, K4 on each CLI's first batch against its
    plain version, and the first train steps and decodes at hidden 64 on
    the card against the CPU.  -> K4's launches in the phase's runs, by
    chain width."""
    t_phase = time.perf_counter()
    by_width: dict = {}
    with tempfile.TemporaryDirectory(prefix="captionax-transformers-") as tmp:
        data = cli_corpus(tmp)
        vocab = load_vocab_pickle(data[data.index("--vocab-path") + 1])
        base = data + ["--synthetic-images", str(CLI_IMAGES), "--max-epochs", "1",
                       "--log-every", "1"]
        say(f"  card memory held before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB"
            + held_tensors())
        runs = {
            "labert": transformer_run(
                cli_labert, "labert", base + ["--checkpoint-dir", os.path.join(tmp, "labert"),
                                              "--run-name", "run"],
                f"train_labert (hidden 768, 12 layers, 12 heads, FFN 3072, V = {len(vocab)} + "
                "[MASK], B = 64, 49 + 25 tokens)",
                lambda p, f, c, t, d: labert_loss(p, f, c, t, d, len(vocab), num_heads=12)),
            "catr": transformer_run(
                cli_catr, "catr", base + ["--checkpoint-dir", os.path.join(tmp, "catr"),
                                          "--run-name", "run"],
                f"train_catr (hidden 256, 8 heads, FFN 2048, 6 + 6 layers, V = {len(vocab)}, "
                "B = 64)",
                lambda p, f, c: cross_entropy_loss(catr_forward(p, f, c[:, :-1], num_heads=8),
                                                   c[:, 1:])),
        }
        for name, rec in runs.items():
            k4_on_cli_batch(rec, f"train_{name}'s encoder")
            for w, n in rec["by_width"].items():
                by_width[w] = by_width.get(w, 0) + n
        transformers_card_vs_cpu(runs, len(vocab))
    say(f"  phase 25: {time.perf_counter() - t_phase:.2f} s [{CARD}]")
    return {"by_width": by_width}


# ------------------------------------------------ phase 26: data parallelism
DP_B = 1024               # (a) and (c): the batch, 512 a rank
DP_STEPS = 3              # (c)
DP_LOSS_RTOL = 1e-5       # (c): the first step's loss against one process on the whole batch
DP_GRAD_SHARE = 1e-4      # (c): of each leaf's largest entry (share_of)
DP_CLI_RTOL = 1e-4        # (d): the train loss against --mesh-data 0; the validation
                          # against one device on the mesh run's parameters
DP_CONTROL_TIMES = 10     # (d): the validation against --mesh-data 0, in the control's
DP_CLI_IMAGES = 480


def dp_devices() -> list:
    """The phase's mesh of 2: two cards where there are two, else the one
    card twice (a mesh's devices may repeat)."""
    return ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0", "cuda:0"]


def dp_model(dev):
    """full_model's hypernet attention-GRU (the same draws) on ``dev``."""
    g = gen(0)
    decoder = attention_gru_init(g, NF, FO, E, H, V, device=dev)
    return {"decoder": decoder,
            "hn": hypernet_init(g, hyper_emb=E, input_dim=E + FO, hidden_dim=H, device=dev)}


def dp_batch(dev) -> dict:
    """A full-width train batch whose first half holds captions of 3-6 words
    and whose second half 16-23: the two shards' token counts differ ~4x."""
    feats = torch.randn((DP_B, R, NF), generator=torch.Generator(device=dev).manual_seed(21),
                        device=dev)
    rs = np.random.RandomState(22)
    caps = np.zeros((DP_B, T_CAP), np.int64)
    for r in range(DP_B):
        n = rs.randint(3, 7) if r < DP_B // 2 else rs.randint(16, T_CAP - 1)
        caps[r, 0], caps[r, 1:n + 1], caps[r, n + 1] = 1, rs.randint(4, V, n), 2
    return {"features": feats, "captions": torch.from_numpy(caps).to(dev),
            "style_id": torch.tensor(STYLE, device=dev)}


def dp_train_rank(steps: int) -> dict:
    """(c) on one rank of the phase's world: the first step's all-reduced
    loss and gradient, then ``steps`` data-parallel K3 steps (timed, K3
    counted, every rank's parameters hashed after each); rank 0 also takes
    the whole batch in one process, and one step over a world-1 NCCL group.
    -> rank 0's readings."""
    import hashlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(devices=dp_devices())
    dev = mesh.local_device
    batch = dp_batch(dev)
    local = shard_batch(mesh, batch)
    tx = make_optimizer(TRAIN_LR)
    train, _ = make_hypernet_steps(tx, fused_scan=True)
    state = create_train_state(replicate_params(mesh, dp_model(dev)), tx, device=dev)
    with data_parallel(mesh):
        loss, grads = tsteps._value_and_grad(lambda p: train.loss_fn(p, local), state.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = reduce_gradients(grads)
        torch.cuda.synchronize()
        reduce_ms = (time.perf_counter() - t0) * 1e3
    loss = float(reduce_metrics({"loss": loss}, mesh.group)["loss"])
    tokens = [int((batch["captions"][a:b] != 0).sum()) for a, b in shard_bounds(DP_B, 2)]
    pstep = tsteps.jit_data_parallel(train, mesh)
    for op in tk.KERNELS:
        op.launches = 0
    times, digests = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = pstep(state, local)
        float(m["train_loss"])
        times.append((time.perf_counter() - t0) * 1e3)
        h = hashlib.sha256()
        for x in tree_leaves(state.params):
            h.update(x.detach().cpu().numpy().tobytes())
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, h.hexdigest())
        digests.append(every)
    k3 = {op.name: op.launches for op in tk.KERNELS}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, k3)
    nccl = dist.new_group([0], backend="nccl")
    out = {"world": dist.get_world_size(), "backend": dist.get_backend(),
           "devices": [str(d) for d in mesh.data_devices], "loss": loss, "tokens": tokens,
           "ms": times, "digests": digests, "k3": counts, "reduce_ms": reduce_ms,
           "entries": sum(x.numel() for x in tree_leaves(grads))}
    if mesh.rank == 0:
        params = replicate_params(Mesh([[dev]]), dp_model(dev))[0]
        ref_loss, ref_grads = tsteps._value_and_grad(lambda p: train.loss_fn(p, batch), params)
        out["ref_loss"] = float(ref_loss)
        out["grad_share"] = {p: share_of(g, r) for p, g, r in zip(
            leaf_paths(grads), tree_leaves(grads), tree_leaves(ref_grads))}
        # one step over NCCL at world 1: the route starts and reduces on the card
        one = Mesh([[dev]], group=nccl, rank=0)
        state1 = create_train_state(params, tx, device=dev)
        _, m1 = tsteps.jit_data_parallel(train, one)(state1, batch)
        out["nccl"] = {"backend": dist.get_backend(nccl), "loss": float(m1["train_loss"])}
    return out


def dp_sharded_decode(model, feats) -> dict:
    """(a) make_sharded_beam_decode at B=1024 over the S=3 bank, f32 and
    bf16, against the unsharded server; -> K1's launches on the sharded
    runs."""
    bank, rows, _ = style_bank(model)
    mesh = make_mesh(devices=dp_devices())
    decoders = {name: (make_sharded_beam_decode(mesh, model["decoder"], bank,
                                                max_steps=MAX_STEPS, f32=f32, packed=True),
                       make_beam_server(model["decoder"], bank, max_steps=MAX_STEPS,
                                        packed=True, f32=f32, device=DEVICE))
                for name, f32 in (("f32", True), ("bf16", False))}
    got, launches = count_launches(
        lambda: {name: unpack_beam_result(fetch(d(feats, rows)))
                 for name, (d, _) in decoders.items()}, "sharded beam decode")
    for name, (sharded, single) in decoders.items():
        ref = serve(single, [(feats, rows)])[0]
        ok = ((got[name].tokens == ref.tokens).all(1) & (got[name].found == ref.found)
              & (got[name].lengths == ref.lengths)
              & (~ref.found | (np.abs(got[name].scores - ref.scores) <= FULL_SCORE_TOL)))
        share = float(ok.mean())
        ms = wall_ms(lambda: fetch(sharded(feats, rows)), 3)
        ms1 = wall_ms(lambda: serve(single, [(feats, rows)]), 3)
        say(f"  sharded beam decode {name}, B={DP_B} over {mesh.n_data} shards: {share:.4f} of "
            f"rows equal the unsharded server's (scores within {FULL_SCORE_TOL}); "
            f"{ms:.2f} ms a batch sharded, {ms1:.2f} ms unsharded [{CARD}]")
        require(share >= FULL_AGREEMENT, f"sharded {name}: agreement {share}")
    return launches


def dp_service(model, enc, images, rows) -> tuple:
    """(b) CaptionService(mesh) of 2 at B=64, beam and greedy, over 192
    concurrent requests, against the one-device service; a batch of 63
    raises.  -> (the kernels' launches, K4's by chain width)."""
    vocab = synthetic_vocab()
    params = {"decoder": mid_copy(model["decoder"]), "hn": model["hn"]}
    mesh = make_mesh(devices=dp_devices())
    launches, by_width = {}, {}
    for decode in ("beam", "greedy"):
        steps = MAX_STEPS if decode == "beam" else MAX_LEN
        kernels = dk.BEAM_KERNELS if decode == "beam" else dk.GREEDY_KERNELS
        kw = dict(batch_size=ENC_B, max_steps=steps, decode=decode)
        with CaptionService(params, enc, vocab, STYLES, mesh=mesh, **kw) as svc, \
                CaptionService(params, enc, vocab, STYLES, device=DEVICE, **kw) as one:
            for s_ in (svc, one):  # a first burst each: cuDNN's plans, the allocator's blocks
                serve_concurrently(s_, images, rows)
            (answers, many, _, n_disp), n = count_launches(
                lambda: serve_concurrently(svc, images, rows), f"sharded {decode} service",
                tuple(kernels) + ck.KERNELS)
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
            for w, v in ck.LAUNCHES_BY_WIDTH.items():
                by_width[w] = by_width.get(w, 0) + v
            want, many1, _, _ = serve_concurrently(one, images, rows)
            stats = svc.stats()
            require(stats["errors"] == 0 and stats["served"] == 2 * (len(images) + 1),
                    f"{stats}")
            check_captions(answers, vocab, f"sharded {decode} service", decode == "beam")
            same = float(np.mean([a["caption"] == b["caption"] for a, b in zip(answers, want)]))
            say(f"  sharded {decode} service: {same:.4f} of {len(images)} captions equal the "
                f"one-device service's; {len(images) / many:.1f} captions/s in {n_disp} "
                f"dispatches, one device {len(images) / many1:.1f} captions/s [{CARD}]")
            require(same >= FULL_AGREEMENT, f"sharded {decode} service: agreement {same}")
    try:
        CaptionService(params, enc, vocab, STYLES, mesh=mesh, batch_size=63)
    except ValueError as e:
        say(f"  batch_size 63 on a mesh of 2 raises ValueError: {e}")
    else:
        raise AssertionError("CaptionService(batch_size=63, mesh of 2) did not raise")
    return launches, by_width


def dp_train_step() -> dict:
    """(c) the data-parallel K3 step on the phase's world; -> K3's launches
    on its steps, summed over the ranks."""
    out = dp_launch.launch(dp_train_rank, 2, (DP_STEPS,), devices=dp_devices())
    say(f"  train world: {out['world']} ranks over {out['backend']} on {out['devices']}; "
        f"non-pad tokens of the two shards {out['tokens']}")
    require(out["tokens"][1] > 2 * out["tokens"][0], f"shard tokens {out['tokens']}")
    rel = abs(out["loss"] - out["ref_loss"]) / abs(out["ref_loss"])
    worst = max(out["grad_share"].items(), key=lambda kv: kv[1])
    say(f"  first step: loss {out['loss']:.7f} against {out['ref_loss']:.7f} in one process on "
        f"the whole batch (relative {rel:.2e}, bound {DP_LOSS_RTOL}); all-reduced gradient "
        f"within {worst[1]:.2e} of each leaf's largest entry (worst {worst[0]}, bound "
        f"{DP_GRAD_SHARE})")
    require(rel <= DP_LOSS_RTOL, f"data-parallel loss: relative {rel}")
    require(worst[1] <= DP_GRAD_SHARE, f"data-parallel gradient {worst}")
    for i, every in enumerate(out["digests"]):
        require(len(set(every)) == 1, f"step {i + 1}: the replicas differ")
    say(f"  {DP_STEPS} steps, B={DP_B} ({DP_B // 2} a rank), T={T_CAP}, f32, K3: "
        + ", ".join(f"{t:.2f}" for t in out["ms"]) + f" ms a step, of it the all-reduce of "
        f"{out['entries']} f32 gradients over {out['backend']} {out['reduce_ms']:.2f} ms (rank "
        f"0, the first step); parameters bit-equal across the ranks after every step [{CARD}]")
    k3 = {name: sum(c[name] for c in out["k3"]) for name in out["k3"][0]}
    say(f"  K3 launches on the data-parallel steps, both ranks: {k3}")
    for name, n in k3.items():
        require(n > 0, f"{name} was not launched on the data-parallel steps")
    nccl = out["nccl"]
    rel1 = abs(nccl["loss"] - out["ref_loss"]) / abs(out["ref_loss"])
    say(f"  one step at world 1 over {nccl['backend']}: loss {nccl['loss']:.7f} (relative "
        f"{rel1:.2e})")
    require(nccl["backend"] == "nccl" and rel1 <= DP_LOSS_RTOL, f"NCCL step {nccl}")
    return k3


def dp_cli_rank(argv: list):
    """(d)'s ``train_hypernet --mesh-data 2`` on one rank, the call
    ``run_on_ranks`` makes in each rank; -> (rank 0's history, every rank's
    kernel launches: K3's, K4's and K4's by chain width)."""
    history = cli_hypernet.main(argv)
    mine = {op.name: op.launches for op in tk.KERNELS + ck.KERNELS}
    mine["k4_by_width"] = dict(ck.LAUNCHES_BY_WIDTH)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return history, every


@contextlib.contextmanager
def rows_in_another_order():
    """(d)'s control: every training batch of ``CaptionTrainer.fit`` with its
    second half of rows first.  The batch's mean loss and its gradient are
    the same sums in another order, as the mesh's shards make them."""
    real = harness.CaptionTrainer._loader

    def rolled(batch):
        rows = len(batch["captions"])
        return {k: (np.concatenate([v[rows // 2:], v[:rows // 2]])
                    if isinstance(v, np.ndarray) and v.ndim and len(v) == rows else v)
                for k, v in batch.items()}

    def loader(self, batches, even=True, **kw):
        return real(self, (rolled(b) for b in batches) if even else batches, even=even, **kw)

    harness.CaptionTrainer._loader = loader
    try:
        yield
    finally:
        harness.CaptionTrainer._loader = real


def dp_cli() -> dict:
    """(d) train_hypernet --mesh-data 2 (--fused-scan: K3; the encoder: K4)
    against --mesh-data 0, B=64, one epoch on the seeded corpus: the
    epoch's train loss; its validation losses against one device's
    validation of the same parameters (the run's checkpoint, resumed at
    learning rate 0: a step that moves nothing); and its distance from
    --mesh-data 0 against a control's, one device with every training
    batch's rows in another order (the same sums reordered, as the mesh
    reorders them), which bounds it at DP_CONTROL_TIMES the control's.
    -> the ranks' launches, summed."""
    with tempfile.TemporaryDirectory(prefix="captionax-dp-") as tmp:
        data = cli_corpus(tmp)
        base = data + ["--synthetic-images", str(DP_CLI_IMAGES), "--max-epochs", "1",
                       "--fused-scan", "--cache-features-device"]
        one_dir, two_dir = os.path.join(tmp, "one"), os.path.join(tmp, "two")
        t0 = time.perf_counter()
        one = cli_hypernet.main(base + ["--checkpoint-dir", one_dir])
        t1 = time.perf_counter()
        two, ranks = dp_launch.launch(
            dp_cli_rank, 2, (base + ["--checkpoint-dir", two_dir, "--mesh-data", "2"],),
            devices=dp_devices())
        t2 = time.perf_counter()
        same = cli_hypernet.main(base + ["--checkpoint-dir", os.path.join(tmp, "same"),
                                         "--resume", two_dir, "--lr", "0"])
        with rows_in_another_order():
            control = cli_hypernet.main(base + ["--checkpoint-dir", os.path.join(tmp, "ctl")])
        keys = ("train_loss_epoch", "val_loss_tf", "val_loss")
        rel = {k: abs(two[0][k] - one[0][k]) / abs(one[0][k]) for k in keys}
        rel_ctl = {k: abs(control[0][k] - one[0][k]) / abs(one[0][k]) for k in keys}
        rel_same = {k: abs(two[0][k] - same[0][k]) / abs(same[0][k])
                    for k in ("val_loss_tf", "val_loss")}
        for k in rel:
            say(f"  train_hypernet {k}: --mesh-data 2 {two[0][k]:.7f}, --mesh-data 0 "
                f"{one[0][k]:.7f} (relative {rel[k]:.2e}); the control, one device with "
                f"the rows reordered, {control[0][k]:.7f} (relative {rel_ctl[k]:.2e})"
                + (f"; one device on the mesh run's parameters {same[0][k]:.7f} (relative "
                   f"{rel_same[k]:.2e})" if k in rel_same else ""))
        p1, p2, pc = (tckpt.restore_checkpoint(d) for d in (one_dir, two_dir,
                                                            os.path.join(tmp, "ctl")))
        lr = float(TrainConfig().lr)
        for what, p in (("--mesh-data 2", p2), ("the control", pc)):
            diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(p1),
                                                                       tree_leaves(p))])
            say(f"  {what} against --mesh-data 0, the parameters after the epoch: max "
                f"|difference| {diffs.max().item():.3e}; {int((diffs > lr / 10).sum())} of "
                f"{diffs.numel()} entries differ by more than lr / 10 = {lr / 10:g}, "
                f"{int((diffs > 0).sum())} at all")
        require(rel["train_loss_epoch"] <= DP_CLI_RTOL,
                f"--mesh-data 2 train loss: relative {rel['train_loss_epoch']}")
        for k, r in rel_same.items():
            require(r <= DP_CLI_RTOL, f"--mesh-data 2 {k} against one device: relative {r}")
        bound = DP_CONTROL_TIMES * max(rel_ctl[k] for k in rel_same)
        say(f"  --mesh-data 2's validation losses from --mesh-data 0's: at most "
            f"{max(rel[k] for k in rel_same):.2e}, bound {bound:.2e} ({DP_CONTROL_TIMES} x the "
            f"control's largest)")
        for k in rel_same:
            require(rel[k] <= bound, f"--mesh-data 2 {k} from --mesh-data 0: relative "
                    f"{rel[k]}, over {DP_CONTROL_TIMES} x the control's")
        steps = [d for d in os.listdir(two_dir) if d.isdigit()]
        rows = [len(logged(os.path.join(d, "run.jsonl"))) for d in (two_dir, one_dir)]
        say(f"  --mesh-data 2 wrote checkpoint directories {steps} and {rows[0]} log rows "
            f"(--mesh-data 0: {rows[1]}); {t1 - t0:.2f} s for --mesh-data 0, {t2 - t1:.2f} s "
            f"for --mesh-data 2 with its ranks' start [{CARD}]")
        require(len(steps) == 1 and rows[0] == rows[1], "rank 0 alone must write")
    out: dict = {"k4_by_width": {}}
    for r in ranks:
        for k, v in r.items():
            if k == "k4_by_width":
                for w, n in v.items():
                    out["k4_by_width"][w] = out["k4_by_width"].get(w, 0) + n
            else:
                out[k] = out.get(k, 0) + v
    say(f"  train_hypernet --mesh-data 2, launches on both ranks: "
        + str({k: v for k, v in out.items() if k != "k4_by_width"}))
    for op in tk.KERNELS + ck.KERNELS:
        require(out.get(op.name, 0) > 0, f"{op.name} was not launched by --mesh-data 2")
    return out


def data_parallelism() -> dict:
    """(26) Data parallelism on a mesh of 2 (two cards, or the one card
    twice): (a) the sharded beam decode, (b) CaptionService(mesh), (c) the
    data-parallel K3 train step, (d) train_hypernet --mesh-data 2.  -> the
    kernels' launches on the phase's paths."""
    devices = dp_devices()
    say(f"  mesh: world 2, backend {backend_for(devices)}, {torch.cuda.device_count()} "
        f"card(s), devices {devices}")
    model = dp_model(DEVICE)
    model["decoder"]["fc"]["b"][2] += EOS_BIAS
    feats = torch.randn((DP_B, R, NF), generator=torch.Generator(device=DEVICE).manual_seed(1),
                        device=DEVICE)
    t = time.perf_counter()
    k1 = dp_sharded_decode(model, feats)
    say(f"  (a) {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    enc = k4_resnet()
    images = random_images(N_MICRO * ENC_B, 17)
    rows = np.random.RandomState(18).randint(0, len(STYLES), len(images)).astype(np.int32)
    svc, svc_width = dp_service(model, enc, images, rows)
    say(f"  (b) {time.perf_counter() - t:.2f} s")
    del model, feats, enc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k3 = dp_train_step()
    say(f"  (c) {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    cli = dp_cli()
    say(f"  (d) {time.perf_counter() - t:.2f} s")
    counts = dict(svc)
    for name, n in list(k1.items()) + list(k3.items()):
        counts[name] = counts.get(name, 0) + n
    for name in [op.name for op in tk.KERNELS + ck.KERNELS]:
        counts[name] = counts.get(name, 0) + cli.get(name, 0)
    by_width = dict(svc_width)
    for w, n in cli["k4_by_width"].items():
        by_width[w] = by_width.get(w, 0) + n
    return {"counts": counts, "by_width": by_width}


# ------------------------------ phase 27: pipeline, sequence, expert and tensor parallelism
PAR_B = CLI_BATCH          # (a), (b): train_labert's batch
PAR_PIPE, PAR_MICRO, PAR_SEQ = 4, 8, 4
PAR_LOSS_RTOL = 1e-5       # (a)-(c): the loss against the sequential stack's
PAR_GRAD_SHARE = 1e-4      # (a)-(c): each gradient, of its leaf's largest entry (share_of)
PAR_CONTROL_TIMES = 10     # (c): an f32 gradient leaf may stray 10x its f32 step's own distance
PAR_EXPERT, PAR_BANK = 4, 12
PAR_BANK_TOL = 1e-6        # (d): the expert bank against synthesize_theta_batched
PAR_ROWS = 0.999           # (d): rows of the two K1 decodes equal
PAR_CLI_IMAGES = 160       # (c), (f): 128 train images, two steps of 64
PAR_FILES = 64             # (f): image files captioned


def labert_batch(T: int, seed: int) -> list:
    """train_labert's step inputs at B=PAR_B on the card: features
    [B, 49, 2048], captions [B, T] of 8..T real tokens, their length-bucket
    types and the mask draws."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    feats = torch.randn((PAR_B, R, NF), generator=g, device=DEVICE)
    rs = np.random.RandomState(seed)
    caps = rs.randint(4, V, (PAR_B, T))
    lengths = rs.randint(8, T + 1, PAR_B)
    caps[np.arange(T)[None, :] >= lengths[:, None]] = 0
    types = np.asarray([length_bucket(int(n)) + 2 for n in lengths])[:, None].repeat(T, 1)
    draws = cli_labert.step_mask_draws(seed, PAR_B, T, DEVICE)
    return [feats, torch.from_numpy(caps).to(DEVICE), torch.from_numpy(types).to(DEVICE), draws]


def against_sequential(what: str, loss_fn, params, encoder_fn) -> dict:
    """``loss_fn(params, encoder_fn)``'s loss and gradients with
    ``encoder_fn`` against the sequential stack's (None), each the second of
    two synced calls; -> the readings."""
    run = {}
    for name, fn in (("sequential", None), (what, encoder_fn)):
        for _ in range(2):
            (loss, grads), ms = synced_ms(
                lambda: tsteps._value_and_grad(lambda p: loss_fn(p, fn), params))
        run[name] = (float(loss), grads, ms)
    (ls, gs, ms_s), (lp, gp, ms_p) = run["sequential"], run[what]
    rel = abs(lp - ls) / abs(ls)
    share, worst = max(zip(map(share_of, tree_leaves(gp), tree_leaves(gs)), leaf_paths(gs)))
    say(f"  {what}: loss {lp:.7f} against the sequential stack's {ls:.7f} (relative {rel:.2e}, "
        f"bound {PAR_LOSS_RTOL}); gradients within {share:.2e} of each leaf's largest entry "
        f"(at least 1e-3; worst {worst}; bound {PAR_GRAD_SHARE}); a loss and its gradients "
        f"{ms_p:.2f} ms, sequential {ms_s:.2f} ms (one process, the second call, synced) "
        f"[{CARD}]")
    require(rel <= PAR_LOSS_RTOL, f"{what}: loss relative {rel}")
    require(share <= PAR_GRAD_SHARE, f"{what}: gradient {worst} {share}")
    return {"rel": rel, "share": share, "ms": ms_p, "ms_seq": ms_s}


def labert_schedules() -> None:
    """(a) LaBERT at train_labert's defaults (hidden 768, 12 layers, 12 heads,
    FFN 3072, V = 9684 + [MASK]), B = 64, 49 + 25 tokens: the loss and its
    gradients over pipe 4 (8 microbatches), then (b) over seq 4, all-gather
    and ring (the text padded to 27 columns), each against the sequential
    stack on the same inputs."""
    slots = default_devices(PAR_PIPE)
    params = cli_labert.build_labert_model(gen(270), V + 1, 768, 12, 12, DEVICE)
    say(f"  LaBERT {count_params(params):,} parameters; mesh slots {[str(d) for d in slots]}")
    loss_of = lambda inputs: (lambda p, enc: labert_loss(p, *inputs, V, num_heads=12,
                                                         encoder_fn=enc))
    inputs = labert_batch(T_CAP, 271)
    against_sequential(f"(a) pipe {PAR_PIPE}, {PAR_MICRO} microbatches", loss_of(inputs), params,
                       pipelined_bert_encoder(pipeline_mesh(PAR_PIPE, devices=slots), PAR_MICRO,
                                              12))
    feats, caps, types, draws = inputs
    padded = [feats, *cli_labert.pad_for_seq(caps, types, draws, R, PAR_SEQ)]
    say(f"  (b) the text padded from {caps.shape[1]} to {padded[1].shape[1]} columns "
        f"({R} + {padded[1].shape[1]} tokens, {PAR_SEQ} shards)")
    for ring in (False, True):
        against_sequential(f"(b) seq {PAR_SEQ}, {'ring' if ring else 'all-gather'}",
                           loss_of(padded), params,
                           sequence_parallel_bert_encoder(
                               sequence_mesh(PAR_SEQ, devices=default_devices(PAR_SEQ)), 12,
                               ring=ring))


def first_step_spies(cli, rec: dict) -> dict:
    """``cli._value_and_grad`` recording each train step's loss and the first
    step's parameters and gradients, and ``cli.make_train_step`` its inputs
    (host copies, made before the optimizer overwrites them)."""
    real_vg, real_make = cli._value_and_grad, cli.make_train_step

    def value_and_grad(fn, params):
        if "params" not in rec:
            rec["params"] = to_device(params, "cpu")
        loss, grads = real_vg(fn, params)
        if "grads" not in rec:
            rec["grads"] = to_device(grads, "cpu")
        rec.setdefault("losses", []).append(float(loss))
        return loss, grads

    def make_train_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def first_inputs(state, *inputs):
            rec.setdefault("inputs", to_device(list(inputs), "cpu"))
            return step(state, *inputs)
        return first_inputs

    return {"_value_and_grad": value_and_grad, "make_train_step": make_train_step}


def f64_grads(loss_fn, params, inputs, stacks=(None,)) -> list:
    """The gradients of ``loss_fn(params, inputs, stack)`` in f64 on the card,
    one tree on the host for each of ``stacks`` (None: the sequential one)."""
    f64 = lambda tree: tree_map(lambda x: x.double() if x.is_floating_point() else x,
                                to_device(tree, DEVICE))
    p, args = f64(params), f64(inputs)
    return [to_device(tsteps._value_and_grad(lambda q: loss_fn(q, args, st), p)[1], "cpu")
            for st in stacks]



def parallel_clis(enc_params) -> tuple:
    """(c) train_labert --pipe 4 and --seq 4 --seq-ring and train_catr --pipe
    2 at their defaults, one epoch of 128 train images (two steps of 64),
    each against the same CLI with --pipe 1: every step's loss, and the
    first step's gradients, in f32 and, on the first step's own weights and
    inputs, in f64.  An f32 leaf beyond PAR_GRAD_SHARE passes only within
    PAR_CONTROL_TIMES the sequential f32 step's own distance from its f64
    gradient (a ReLU whose input is float noise from 0 flips between two
    roundings of the same sums).  -> (K4's launches, by chain width)."""
    labert_loss_of = lambda p, a, enc: labert_loss(p, *a, V, num_heads=12, encoder_fn=enc)

    def catr_loss_of(p, a, stacks):
        enc, dec = stacks or (None, None)
        return cross_entropy_loss(catr_forward(p, a[0], a[1][:, :-1], encoder_fn=enc,
                                               decoder_fn=dec, num_heads=8), a[1][:, 1:])

    pipe = lambda n: pipeline_mesh(n, devices=default_devices(n))
    runs = {
        "train_labert": (cli_labert, labert_loss_of, {
            "--pipe 1": ([], None),
            "--pipe 4": (["--pipe", "4"], lambda: pipelined_bert_encoder(pipe(4), 8, 12)),
            "--seq 4 --seq-ring": (["--seq", "4", "--seq-ring"],
                                   lambda: sequence_parallel_bert_encoder(
                                       sequence_mesh(4, devices=default_devices(4)), 12,
                                       ring=True))}),
        "train_catr": (cli_catr, catr_loss_of, {
            "--pipe 1": ([], None),
            "--pipe 2": (["--pipe", "2"], lambda: pipelined_catr_stacks(pipe(2), 4, 8))})}
    before = k4_counts()
    with tempfile.TemporaryDirectory(prefix="captionax-par-") as tmp:
        data = seeded_corpus(tmp, PAR_CLI_IMAGES, CLI_BATCH)
        for name, (cli, loss_of, variants) in runs.items():
            recs = {}
            for flag, (extra, _) in variants.items():
                rec: dict = {}
                ckdir = os.path.join(tmp, f"{name}{len(recs)}")
                argv = data + ["--synthetic-images", str(PAR_CLI_IMAGES), "--max-epochs", "1",
                               "--checkpoint-dir", ckdir] + extra
                t0 = time.perf_counter()
                with patched(cli, build_encoder=lambda *a, **k: enc_params,
                             **first_step_spies(cli, rec)):
                    cli.main(argv)
                torch.cuda.synchronize()
                rec["s"] = time.perf_counter() - t0
                recs[flag] = rec
            (_, base), *others = recs.items()
            require(len(base["losses"]) == 2, f"{name}: {len(base['losses'])} steps")
            paths = leaf_paths(base["grads"])
            g64_base = f64_grads(loss_of, base["params"], base["inputs"])[0]
            control = list(map(share_of, tree_leaves(base["grads"]), tree_leaves(g64_base)))
            del g64_base
            for flag, rec in others:
                rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], base["losses"]))
                same_bits(rec["params"], base["params"], f"{name} {flag}: the first weights")
                g64_seq, g64_par = f64_grads(loss_of, rec["params"], rec["inputs"],
                                             (None, variants[flag][1]()))
                share64 = max(map(share_of, tree_leaves(g64_par), tree_leaves(g64_seq)))
                f32 = list(map(share_of, tree_leaves(rec["grads"]), tree_leaves(base["grads"])))
                share, worst, ctl = max(zip(f32, paths, control))
                over = [(p, s, c) for s, p, c in zip(f32, paths, control) if s > PAR_GRAD_SHARE]
                say(f"  (c) {name} {flag}: step losses "
                    + ", ".join(f"{x:.6f}" for x in rec["losses"]) + " against --pipe 1's "
                    + ", ".join(f"{x:.6f}" for x in base["losses"])
                    + f" (relative at most {rel:.2e}, bound {PAR_LOSS_RTOL}); the first step's "
                    f"gradients in f32 within {share:.2e} of each leaf's largest entry (worst "
                    f"{worst}; --pipe 1's own f32 step is {ctl:.2e} from its f64 gradient "
                    f"there), {len(over)} of {len(paths)} leaves over {PAR_GRAD_SHARE}"
                    + "".join(f"; {p}: {s:.2e}, control {c:.2e}" for p, s, c in over[:4])
                    + f"; in f64 on the same weights and inputs within {share64:.2e} (bound "
                    f"{PAR_GRAD_SHARE}); the run {rec['s']:.2f} s, --pipe 1 {base['s']:.2f} s "
                    f"[{CARD}]")
                require(len(rec["losses"]) == len(base["losses"]) and rel <= PAR_LOSS_RTOL,
                        f"{name} {flag}: losses {rec['losses']} {base['losses']}")
                require(share64 <= PAR_GRAD_SHARE, f"{name} {flag}: f64 gradient {share64}")
                for p, s, c in over:
                    require(s <= PAR_CONTROL_TIMES * c,
                            f"{name} {flag}: gradient {p} {s}, over {PAR_CONTROL_TIMES} x {c}")
    return k4_since(before)


def expert_bank() -> dict:
    """(d) expert_theta_bank over expert 4 at full width (E = H = 200, S =
    12) against synthesize_theta_batched, then a B = 1024 mixed-style K1
    beam decode (f32, </s> +0.26) on each bank.  -> K1's launches."""
    model = dp_model(DEVICE)
    embeds = style_table(model)[torch.arange(4, 4 + PAR_BANK, device=DEVICE)]
    mesh = sequence_mesh(PAR_EXPERT, seq_axis="expert", devices=default_devices(PAR_EXPERT))
    bank, ms = synced_ms(expert_theta_bank(mesh, "expert"), model, embeds)
    ref, ms_ref = synced_ms(synthesize_theta_batched, model, embeds)
    err = max((bank[k] - ref[k]).abs().max().item() for k in ref)
    say(f"  (d) expert bank over {PAR_EXPERT} slots, S = {PAR_BANK}: "
        + ", ".join(f"{k} {list(v.shape)}" for k, v in bank.items())
        + f"; max |difference| from synthesize_theta_batched {err:.3e} (bound {PAR_BANK_TOL}); "
        f"{ms:.2f} ms, batched {ms_ref:.2f} ms [{CARD}]")
    require(err <= PAR_BANK_TOL, f"expert bank: {err}")
    dec = mid_copy(model["decoder"], EOS_BIAS + MID_BIAS)  # +MID_BIAS on </s>
    feats = torch.randn((B, R, NF), generator=torch.Generator(device=DEVICE).manual_seed(27),
                        device=DEVICE)
    rows = np.random.RandomState(27).randint(0, PAR_BANK, B).astype(np.int32)
    servers = [make_beam_server(dec, b, max_steps=MAX_STEPS, packed=True, f32=True,
                                device=DEVICE) for b in (bank, ref)]
    (got, want), launches = count_launches(
        lambda: [serve(s, [(feats, rows)])[0] for s in servers], "expert-bank beam decode")
    ok = ((got.tokens == want.tokens).all(1) & (got.found == want.found)
          & (got.lengths == want.lengths)
          & (~want.found | (np.abs(got.scores - want.scores) <= FULL_SCORE_TOL)))
    check_outputs([got], "expert-bank beam decode", min_found=0.05)
    say(f"  (d) K1 on the expert bank against K1 on the batched bank, B = {B}, {PAR_BANK} "
        f"styles: {int(ok.sum())}/{B} rows equal in tokens, found and lengths with scores "
        f"within {FULL_SCORE_TOL} (bound {PAR_ROWS}) [{CARD}]")
    require(ok.mean() >= PAR_ROWS, f"expert-bank decode: {ok.mean()}")
    return launches


def scale_checks() -> None:
    """(e) scale_check --kind hypernet --mesh-data 2 --mesh-model 2 at its
    defaults (V = 9684), and --kind labert --pipe 4 (hidden 768, 12 layers),
    on the card's slots."""
    import io

    for argv in (["--kind", "hypernet", "--mesh-data", "2", "--mesh-model", "2"],
                 ["--kind", "labert", "--pipe", "4"]):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli_scale_check.main(argv)
        torch.cuda.synchronize()
        lines = out.getvalue().strip().splitlines()
        say(f"  (e) scale_check {' '.join(argv)}: {time.perf_counter() - t0:.2f} s")
        for line in lines:
            say(f"      {line}")
        require(lines[-1] == "scale_check OK", f"scale_check {argv}: {lines[-1:]}")


def same_bits(a, b, what: str) -> int:
    """Equal trees (keys, lengths, shapes, dtypes, bits); -> the tensors."""
    la, lb = tree_leaves(a), tree_leaves(b)
    require(leaf_paths(a) == leaf_paths(b) and len(la) == len(lb), f"{what}: structure")
    for p, x, y in zip(leaf_paths(a), la, lb):
        require(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu()),
                f"{what}: {p} differs")
    return len(la)


def checkpoint_bridge(enc_params) -> tuple:
    """(f) train_hypernet at full width for one short epoch (160 synthetic
    images, --fused-scan) on a ResNet-152 given as a torchvision state dict;
    export_checkpoint of its checkpoint with the trunk, import_checkpoint of
    that .ckpt with --encoder-out; the parameters and the trunk back bit for
    bit; then caption (beam over three styles, greedy) on 64 image files
    from the original checkpoint and from the imported one.  -> (the
    launches of the caption runs and of train_hypernet, K4's by width)."""
    counts: dict = {}
    by_width: dict = {}

    def add(c, w):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        for k, v in w.items():
            by_width[k] = by_width.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="captionax-bridge-") as tmp:
        data = seeded_corpus(tmp, PAR_CLI_IMAGES, CLI_BATCH)
        trunk = os.path.join(tmp, "resnet152.pt")
        torch.save(convert.encoder_state_dict_from_params(enc_params), trunk)
        trained, back = os.path.join(tmp, "trained"), os.path.join(tmp, "imported")
        reset_cli_counts()
        t0 = time.perf_counter()
        cli_hypernet.main(data + ["--synthetic-images", str(PAR_CLI_IMAGES), "--max-epochs", "1",
                                  "--checkpoint-dir", trained, "--encoder-weights", trunk,
                                  "--fused-scan"])
        torch.cuda.synchronize()
        add(cli_counts(), dict(ck.LAUNCHES_BY_WIDTH))
        t1 = time.perf_counter()
        ckpt = os.path.join(tmp, "hypernet.ckpt")
        blob = cli_export.main(["--checkpoint-dir", trained, "--kind", "hypernet", "--out", ckpt,
                                "--encoder-weights", trunk, "--hparams", '{"lr": 0.005}'])
        t2 = time.perf_counter()
        imported = cli_import.main(["--ckpt", ckpt, "--out", back, "--encoder-out",
                                    os.path.join(tmp, "trunk.pt")])
        t3 = time.perf_counter()
        n = same_bits(tckpt.restore_checkpoint(back), tckpt.restore_checkpoint(trained),
                      "the imported checkpoint")
        m = same_bits(torch.load(os.path.join(tmp, "trunk.pt"), weights_only=True),
                      torch.load(trunk, weights_only=True), "the imported trunk")
        say(f"  (f) train_hypernet ({PAR_CLI_IMAGES} images, one epoch, --fused-scan) "
            f"{t1 - t0:.2f} s; export_checkpoint {len(blob['state_dict'])} tensors "
            f"({os.path.getsize(ckpt) / 1e6:.1f} MB) {t2 - t1:.2f} s; import_checkpoint "
            f"(kind {imported['kind']}) {t3 - t2:.2f} s; the re-imported checkpoint's {n} tensors "
            f"and the trunk's {m} equal the originals bit for bit [{CARD}]")
        rs = np.random.RandomState(27)
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        for i in range(PAR_FILES):
            h, w = rs.randint(96, 481, 2)
            write_image(img_dir, f"img{i:03d}", rs.randint(0, 256, (h, w, 3), np.uint8),
                        i % 2 == 0)
        vocab_path = data[data.index("--vocab-path") + 1]
        runs = {"beam": (["--decode", "beam", "--styles", ",".join(CLI_STYLES)],
                         dk.BEAM_KERNELS),
                "greedy": (["--decode", "greedy"], dk.GREEDY_KERNELS)}
        for name, (extra, kernels) in runs.items():
            rows = {}
            for which, ckdir, weights in (("original", trained, trunk),
                                          ("imported", back, os.path.join(tmp, "trunk.pt"))):
                out = os.path.join(tmp, f"{name}_{which}.jsonl")
                flags = ["--vocab-path", vocab_path, "--checkpoint-dir", ckdir,
                         "--encoder-weights", weights, "--images", img_dir, "--out", out,
                         "--beam-max-steps", str(MAX_STEPS)] + extra
                t0 = time.perf_counter()
                _, launches = count_launches(lambda: cli_caption.main(flags),
                                             f"(f) caption --decode {name}, {which}",
                                             tuple(kernels) + ck.KERNELS)
                add(launches, dict(ck.LAUNCHES_BY_WIDTH))
                rows[which] = read_jsonl(out)
                say(f"  (f) caption --decode {name} from the {which} checkpoint: "
                    f"{len(rows[which])} rows, {time.perf_counter() - t0:.2f} s")
            a, b = rows["original"], rows["imported"]
            same = [x == y for x, y in zip(a, b)]
            say(f"  (f) caption --decode {name}: {sum(same)}/{len(a)} rows of the imported "
                f"checkpoint equal the original's (image, style, caption"
                + (", score, completed" if name == "beam" else "") + f") [{CARD}]")
            require(len(a) == len(b) == PAR_FILES * (len(CLI_STYLES) if name == "beam" else 1)
                    and all(same), f"(f) caption {name}: {sum(same)}/{len(a)} rows equal")
    return counts, by_width


def parallelism_and_bridge() -> dict:
    """(27) Pipeline, sequence, expert and tensor parallelism in one process
    over the card's slots, and the checkpoint bridge: (a)-(f) above.  ->
    the kernels' launches on the phase's paths."""
    counts: dict = {}
    by_width: dict = {}

    def add(c, w=None):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        for k, v in (w or {}).items():
            by_width[k] = by_width.get(k, 0) + v

    say(f"  {torch.cuda.device_count()} card(s); mesh slots from default_devices: a card "
        f"repeats where there are fewer")
    enc = k4_resnet(25)
    t = time.perf_counter()
    labert_schedules()
    say(f"  (a), (b) {time.perf_counter() - t:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k4, k4_width = parallel_clis(enc)
    add({}, k4_width)
    say(f"  (c) {time.perf_counter() - t:.2f} s; K4 launches {k4}")
    require(k4 > 0, "(c): K4 did not launch")
    t = time.perf_counter()
    add(expert_bank())
    say(f"  (d) {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    scale_checks()
    say(f"  (e) {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    add(*checkpoint_bridge(enc))
    say(f"  (f) {time.perf_counter() - t:.2f} s")
    for op in dk.BEAM_KERNELS + dk.GREEDY_KERNELS:
        require(counts.get(op.name, 0) > 0, f"{op.name} was not launched in phase 27")
    say("  phase 27 launches: " + str(counts)
        + f"; K4 by chain width {by_width}")
    return {"counts": counts, "by_width": by_width}


# ------------------------------------------------------------------ 28
TEXT_IMAGES = 3000     # seeded_corpus images: 15,000 captions to encode, 3,000 CIDEr hypotheses
CIDER_TOL = 1e-9       # native against Python CIDEr (tests/test_cider_native.py's bound)
VIZ_IMAGES = 8
VIZ_DOMAINS = 8
VIZ_AGREEMENT = 0.99   # greedy rows, card against CPU on the card's features, as phases 20-27


def host_libraries(tmp: str) -> dict:
    """(a) Each host library compiled afresh into a temporary build directory
    (timed; csrc/ is never written), then both loaders must load theirs:
    here a failed build fails the phase instead of falling back to Python.
    -> seconds by library."""
    seconds = {}
    with patched(native_build, BUILD_DIR=Path(tmp) / "build"):
        for mod in (textenc_native, cider_native):
            t0 = time.perf_counter()
            try:
                native_build.build(mod.SOURCE)
            except subprocess.CalledProcessError as exc:
                raise AssertionError(f"{mod.SOURCE.name} does not build: "
                                     + (exc.stderr or b"").decode(errors="replace")[-2000:])
            seconds[mod.SOURCE.name] = time.perf_counter() - t0
    loaded = {"textenc.cc": textenc_native.native_available(),
              "cider.cc": cider_native.native_available()}
    say("  (a) host libraries built afresh with g++ (" + " ".join(native_build.CXX_FLAGS)
        + "): " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; loaded by the port's loaders: {loaded} [{CARD}]")
    require(all(loaded.values()), f"(a) a native library does not load: {loaded}")
    return seconds


def caption_encoders(tmp: str) -> dict:
    """(b) The native caption encoder against ``Vocab.encode`` on
    seeded_corpus's captions (ASCII): equal ids, and captions/s of each."""
    flags = seeded_corpus(tmp, TEXT_IMAGES, CLI_BATCH)
    vocab = load_vocab_pickle(flags[flags.index("--vocab-path") + 1])
    caps = [c for _, c in load_factual_captions(flags[flags.index("--factual-captions") + 1])]
    T = TrainConfig().max_len
    enc = textenc_native.NativeCaptionEncoder(vocab)
    t0 = time.perf_counter()
    native = enc.encode_batch(caps, T)
    t1 = time.perf_counter()
    one_by_one = np.stack([enc.encode_batch([c], T)[0] for c in caps])
    t2 = time.perf_counter()
    python = np.zeros_like(native)
    for i, c in enumerate(caps):
        ids = vocab.encode(c)[:T]
        python[i, :len(ids)] = ids
    t3 = time.perf_counter()
    rates = {"native_batch": len(caps) / (t1 - t0), "native_per_caption": len(caps) / (t2 - t1),
             "python": len(caps) / (t3 - t2)}
    same = (native == python).all(axis=1)
    say(f"  (b) caption encoding, {len(caps)} captions, max_len {T}: native in one call "
        f"{rates['native_batch']:.1f} captions/s, native a caption a call (the datasets' "
        f"way) {rates['native_per_caption']:.1f}, Python (Vocab.encode) {rates['python']:.1f}; "
        f"{int(same.sum())}/{len(caps)} rows equal [{CARD}]")
    require(same.all() and (one_by_one == native).all(),
            f"(b) native ids differ from Python ids in {int((~same).sum())} rows")
    return {"captions": len(caps), "rates": rates, "caps": caps}


def cider_scorers(caps: list) -> dict:
    """(c) The native CIDEr scorer against the Python one, a hypothesis an
    image: image i's first caption against that caption less its last three
    words and the image's next three captions."""
    n = len(caps) // 5
    hyps = [caps[5 * i] for i in range(n)]
    refs = [[" ".join(caps[5 * i].split()[:-3])] + caps[5 * i + 1:5 * i + 4] for i in range(n)]
    t0 = time.perf_counter()
    mean, scores = cider_native.cider_score_native(hyps, refs)
    t1 = time.perf_counter()
    py_mean, py_scores = cider_score(hyps, refs)
    t2 = time.perf_counter()
    err = float(np.abs(scores - py_scores).max())
    say(f"  (c) CIDEr over {n} hypotheses (four references each): native {t1 - t0:.4f} s, "
        f"Python {t2 - t1:.4f} s ({(t2 - t1) / (t1 - t0):.1f}x); mean {mean:.6f} against "
        f"{py_mean:.6f}, largest distance {err:.3g} [{CARD}]")
    require(err <= CIDER_TOL and abs(mean - py_mean) <= CIDER_TOL and mean > 0,
            f"(c) native CIDEr differs from the Python scorer by {err}")
    return {"native_s": t1 - t0, "python_s": t2 - t1, "hypotheses": n}


def report_cells(path: str) -> list:
    with open(path) as f:
        html_text = f.read()
    return [re.findall(r"<td[^>]*>(.*?)</td>", row)
            for row in re.findall(r"<tr>(.*?)</tr>", html_text)]


def visualize_runs(tmp: str) -> dict:
    """(d) visualize on the card at its defaults (E=F=H=200, ResNet-152 given
    as a torchvision state dict with every folded scale drawn, the seeded
    9,684-word vocab, random decoder weights) over VIZ_IMAGES synthetic
    images: the hypernet (a column per style), --kind gru, --dataset cc
    (VIZ_DOMAINS domains).  Each report must parse with a row per image (per
    domain) and a column per style; each greedy decode runs again on the CPU
    on the card's features with the same weights.  -> the launches, K4's
    by width, and the seconds of each run."""
    flags = seeded_corpus(tmp, 64, CLI_BATCH)
    vocab = load_vocab_pickle(flags[flags.index("--vocab-path") + 1])
    trunk = os.path.join(tmp, "resnet152.pt")
    torch.save(convert.encoder_state_dict_from_params(k4_resnet(28)), trunk)
    rs = np.random.RandomState(28)
    words = [vocab.i2w[i] for i in range(7, len(vocab))]
    cc_path = os.path.join(tmp, "cc_train.txt")
    with open(cc_path, "w") as f:
        for d in range(VIZ_DOMAINS):
            for i in range(3):
                f.write(f"d{d}_{i}.jpg{SEP_CC}{' '.join(rs.choice(words, 10))}{SEP_CC}"
                        f"web{d:02d}\n")
    flags += ["--encoder-weights", trunk, "--num-images", str(VIZ_IMAGES),
              "--checkpoint-dir", os.path.join(tmp, "no_checkpoint")]
    runs = {"hypernet": ([], 2 + len(cli_visualize.STYLES), VIZ_IMAGES),
            "gru": (["--kind", "gru"], 3, VIZ_IMAGES),
            "cc": (["--dataset", "cc", "--cc-captions", cc_path, "--domain-scheme", CC_SCHEME],
                   4, VIZ_DOMAINS)}
    calls: list = []

    def spy(params, feats, **kw):
        out = greedy(params, feats, **kw)
        calls.append((params, feats, kw, out))
        return out

    counts: dict = {}
    by_width: dict = {}
    seconds = {}
    for name, (extra, cols, n_rows) in runs.items():
        out = os.path.join(tmp, f"{name}.html")
        for op in dk.KERNELS + tk.KERNELS + ck.KERNELS:
            op.launches = 0
        ck.LAUNCHES_BY_WIDTH.clear()
        t0 = time.perf_counter()
        with patched(cli_visualize, greedy=spy):
            cli_visualize.main(flags + extra + ["--out", out])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        for op in dk.KERNELS + tk.KERNELS + ck.KERNELS:
            counts[op.name] = counts.get(op.name, 0) + op.launches
        widths = dict(ck.LAUNCHES_BY_WIDTH)
        for w, c in widths.items():
            by_width[w] = by_width.get(w, 0) + c
        cells = report_cells(out)
        say(f"  (d) visualize {name}: {seconds[name]:.2f} s, {len(cells) - 1} rows of "
            f"{len(cells[0])} columns, K4 launches by chain width {widths}; first row "
            f"{cells[1][1:]} [{CARD}]")
        require(len(cells) == 1 + n_rows and all(len(c) == cols for c in cells),
                f"(d) visualize {name}: {len(cells)} rows, columns {[len(c) for c in cells]}")
        require(all(c[0].startswith("<img src='data:image/png;base64,") for c in cells[1:]),
                f"(d) visualize {name}: a row without its image")
        require(sum(widths.values()) > 0, f"(d) visualize {name}: K4 did not launch")
    same = rows = 0
    for params, feats, kw, out in calls:
        ref = greedy(params, feats, **dict(kw, device="cpu"))
        same += int((ref.numpy() == out.cpu().numpy()).all(axis=1).sum())
        rows += out.shape[0]
    say(f"  (d) greedy rows of the three reports decoded again on the CPU on the card's "
        f"features: {same}/{rows} equal [{CARD}]")
    require(rows == VIZ_IMAGES * (len(cli_visualize.STYLES) + 1) + VIZ_DOMAINS
            and same >= VIZ_AGREEMENT * rows, f"(d) {same}/{rows} greedy rows equal the CPU's")
    return {"counts": counts, "by_width": by_width, "seconds": seconds}


def native_and_visualize() -> dict:
    """(28) The last four modules: the host libraries (a), the native caption
    encoder (b) and CIDEr scorer (c) against their Python versions, the PTB
    tokenizer, and visualize on the card (d)."""
    with tempfile.TemporaryDirectory(prefix="captionax-native-") as tmp:
        t = time.perf_counter()
        builds = host_libraries(tmp)
        text = caption_encoders(tmp)
        cider = cider_scorers(text.pop("caps"))
        toks = PTBTokenizer().tokenize({0: [{"caption": 'A dog (a "big" one) runs, fast!'}]})
        say(f"  PTB tokenizer: {toks[0]}; (a)-(c) {time.perf_counter() - t:.2f} s")
        require(toks[0] == ["a dog a big one runs fast"], f"PTB tokenizer: {toks}")
    with tempfile.TemporaryDirectory(prefix="captionax-visualize-") as tmp:
        viz = visualize_runs(tmp)
    return dict(viz, builds=builds, text=text, cider=cider)


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
    base_rss_mb = proc_rss_mb(os.getpid())
    with Phase("2 small-shape exactness, beam"):
        small_exactness()
    with Phase("3 small-shape exactness, greedy"):
        small_greedy_exactness()
    with Phase("3b the bf16 vocab products at their edges and ties"):
        vocab_edges()
    with Phase("3c the select kernels at their edges"):
        select_edges()
    paths = {"beam": {}, "greedy": {}}
    with Phase("4 full width, beam main path"):
        model, theta, batches = full_model()
        paths["beam"]["main"], server = main_path(model, theta, batches)
    with Phase("4b the cell step at its edges"):
        cell_edges(model, theta, batches)
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
        service_step_times(model, batches)
        sel = select_times(model)
        for k in kernels:
            kind = {"beam_select": "beam", "greedy_select": "greedy"}.get(k["name"])
            if kind:
                k["ms_b64"] = sel[(kind, ENC_B)]["select_ms"][0]
                k["launch_floor_ms"] = min(sel["floor"].values())
                if kind == "greedy":
                    k["ms_pdl"] = sel[(kind, B)]["select_pdl_ms"][0]
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
    with Phase("16 small-shape exactness, K4"):
        enc = k4_resnet()
        k4_small(enc)
    images = random_images(N_MICRO * ENC_B, 17)
    rows = np.random.RandomState(18).randint(0, len(STYLES), len(images)).astype(np.int32)
    with Phase("17 full width, K4 against its plain version"):
        encoders, x, ins, errs = k4_full(enc, images[:ENC_B])
    served = {}
    try:
        with Phase("18 the caption service: beam (K4 + K1), greedy (K4 + K2)"):
            for decode in ("beam", "greedy"):
                served[decode] = service_path(model, enc, images, rows, decode)
        with Phase("19 times, images in"):
            kernels += k4_times(enc, encoders, x, ins, errs, served, images, rows)
            k4_width_sweep(encoders, ins)
            say("  the service's decode, K1c and K2c at B=64 (phase 11's readings):")
            say_select_times(sel, (ENC_B,))
    finally:
        for svc, _, _ in served.values():
            svc.close()
    with Phase("20 the training CLIs: train_hypernet (K3, K4), evaluate, train_gru bf16"):
        cli = training_clis()
    for k in kernels:
        if k["name"] in cli["counts"]:
            k["launches_training_cli"] = cli["counts"][k["name"]]
        elif k["source"] == K4_SOURCE:
            width = int(k["name"].split()[2]) - 1
            k["launches_training_cli"] = cli["by_width"].get(256 * 2 ** width, 0)
    with Phase("21 the caption and serve CLIs: caption (K4 + K1, K2), serve (bf16, int8), "
               "the supervisor"):
        cap = caption_and_serve(model, enc, base_rss_mb)
    for k in kernels:
        op = k["name"].split(" (")[0]
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            for run, (_, by_width) in cap["caption"].items():
                k[f"launches_caption_{run}"] = by_width.get(width, 0)
            k["launches_serve"] = cap["serve"]["bf16"][1].get(width, 0)
        elif k["replaces"] in (BEAM_TPU, GREEDY_TPU):
            runs = ("beam", "requests") if k["replaces"] == BEAM_TPU else ("greedy",)
            for run in runs:
                k[f"launches_caption_{run}"] = cap["caption"][run][0][op]
            if k["replaces"] == BEAM_TPU:
                k["launches_serve"] = cap["serve"]["bf16"][0][op]
                k["launches_serve_int8"] = cap["serve"]["int8"][0][op]
    with Phase("22 the style classifiers and losses: train_classifier (small, BERT-base), "
               "train_hypernet --mixup, --style-aux, --mixup-split (K4)"):
        style = style_losses()
    for k in kernels:
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_style_losses"] = style["by_width"].get(width, 0)
    with Phase("23 Conceptual Captions and zero-shot: cc_train_hypernet (K3, K4), "
               "test_zero_shot, the six schemes, train_hyper_combine, test_all, cc_train_gru, "
               "train_cc, train_init"):
        ccz = cc_zero_shot()
    for k in kernels:
        if k["name"] in ccz["counts"]:
            k["launches_cc"] = ccz["counts"][k["name"]]
        elif k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_cc"] = ccz["by_width"].get(width, 0)
    # the earlier phases' card memory goes before the 58.5 GB model comes:
    # their locals here, and the trainers the CLI phases left in reference
    # cycles (a trainer's FeatureCache holds its bound _encode), which only
    # a collection frees
    del model, theta, batches, server, gserver, paths, enc, encoders, x, ins, batch, served
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with Phase("24 the cell and LSTM captioners: train_captioning (the v0 hypernet, 3.657 B "
               "parameters), capgru_loss card against CPU, train_lstm's four variants (K4)"):
        cells = cell_lstm_captioners()
    for k in kernels:
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_cell_lstm"] = cells["by_width"].get(width, 0)
    del cells
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with Phase("25 the transformer captioners: train_labert (106.7 M parameters), train_catr "
               "(25.8 M), their first steps and decodes card against CPU (K4)"):
        trans = transformer_captioners()
    for k in kernels:
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_transformers"] = trans["by_width"].get(width, 0)
    del trans
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with Phase("26 data parallelism: the sharded beam decode (K1), CaptionService(mesh) (K4 + "
               "K1, K2), the data-parallel K3 step, train_hypernet --mesh-data 2 (K3, K4)"):
        dp = data_parallelism()
    for k in kernels:
        op = k["name"].split(" (")[0]
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_data_parallel"] = dp["by_width"].get(width, 0)
        elif op in dp["counts"]:
            k["launches_data_parallel"] = dp["counts"][op]
    del dp
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with Phase("27 pipeline, sequence, expert and tensor parallelism, the checkpoint bridge: "
               "LaBERT over pipe 4 and seq 4, train_labert --pipe/--seq, train_catr --pipe "
               "(K4), the expert bank (K1), scale_check, export/import then caption (K4 + K1, "
               "K2)"):
        par = parallelism_and_bridge()
    for k in kernels:
        op = k["name"].split(" (")[0]
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_parallel"] = par["by_width"].get(width, 0)
        else:
            k["launches_parallel"] = par["counts"].get(op, 0)
    del par
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with Phase("28 the last four modules: the native caption encoder and CIDEr scorer against "
               "their Python versions, the PTB tokenizer, visualize (K4)"):
        viz = native_and_visualize()
    for k in kernels:
        op = k["name"].split(" (")[0]
        if k["source"] == K4_SOURCE:
            width = 256 * 2 ** (int(k["name"].split()[2]) - 1)
            k["launches_visualize"] = viz["by_width"].get(width, 0)
        else:
            k["launches_visualize"] = viz["counts"].get(op, 0)
    signal.alarm(0)
    say(f"total {time.perf_counter() - t0:.2f} s")
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
