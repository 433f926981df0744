"""Batch-caption a directory of images from a checkpoint -> JSONL.

Port of ``captionax/cli/caption.py``.  Each batch of image files is read,
decoded and resized on the host (``data/native_image.load_paths_batch``:
the native decoder across a thread pool, PIL for what it cannot decode),
copied to the card, preprocessed and encoded by the frozen ResNet in bf16
(its stride-1 bottleneck chains on K4); the hypernet synthesizes one theta
per style, and the beam decode runs on K1 (``--decode greedy``: K2).  A
:class:`PipelinedDecoder` keeps one batch in flight, so batch i+1's host
decode and encoder overlap batch i's decode.  One JSON line per (image,
style), or per request row with ``--requests``: a mixed-style stream over
a theta bank, each row picking its style.

    python -m captionax_torch.cli.caption --images /path/to/jpgs \\
        --checkpoint-dir ckpt --kind hypernet --styles factual,humour \\
        --out captions.jsonl

Runs on the card unless ``--device cpu`` is given; there (or with
``--no-fused``) the plain ``beam_search`` / ``greedy`` decode with one
theta per row.  The weights are drawn from ``model_generators(--seed)``
as the training CLIs draw theirs, so without ``--encoder-weights`` the
encoder is the one the training run with the same ``--seed`` used.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from captionax_torch.cli.common import (
    build_captioner,
    build_encoder,
    build_hypernet_model,
    make_parser,
    model_generators,
    parse_configs,
    resolve_mesh,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data import native_image
from captionax_torch.data.transforms import preprocess_images
from captionax_torch.decode.search import beam_search, greedy
from captionax_torch.decode.serving import PipelinedDecoder, pack_beam_result, unpack_beam_result
from captionax_torch.eval.metrics import ids_to_text
from captionax_torch.models.encoder import CNNEncoder
from captionax_torch.ops.decode_kernel import BeamDecoder, GreedyDecoder
from captionax_torch.train.checkpoint import restore_checkpoint
from captionax_torch.train.steps import (
    resolve_style_id,
    style_table,
    synthesize_theta,
    synthesize_theta_batched,
)


def _result_rows(result, decode: str, vocab):
    """A fetched result -> JSON-ready rows (the per-style and the mixed
    request paths)."""
    if decode == "greedy":
        return [{"caption": ids_to_text(t, vocab)} for t in np.asarray(result)]
    res = unpack_beam_result(np.asarray(result))
    return [
        {"caption": ids_to_text(res.tokens[j], vocab),
         "score": float(res.scores[j]),
         "completed": bool(res.found[j])}
        for j in range(res.tokens.shape[0])
    ]


def iter_image_files(path: str):
    exts = (".jpg", ".jpeg", ".png")
    if os.path.isfile(path):
        yield path
        return
    for name in sorted(os.listdir(path)):
        if name.lower().endswith(exts):
            yield os.path.join(path, name)


def _padded(imgs: np.ndarray, B: int) -> np.ndarray:
    """The last chunk padded with zero images to the batch of B."""
    if len(imgs) == B:
        return imgs
    return np.concatenate([imgs, np.zeros((B - len(imgs),) + imgs.shape[1:], np.uint8)])


def _decode_fn(decoder, gru_params, decode: str, max_steps: int, use_fused: bool, device):
    """(features, style rows or None) -> the device result: packed beam
    results or greedy tokens.  ``gru_params`` is one theta, a bank with a
    leading style axis (rows pick from it), or None for a plain GRU."""
    bank = gru_params is not None and gru_params["w_ih"].dim() == 3
    if use_fused:
        if decode == "greedy":
            fused = GreedyDecoder(decoder, gru_params, max_len=max_steps, device=device)
        else:
            fused = BeamDecoder(decoder, gru_params, max_steps=max_steps, device=device)

        def run(feats, rows=None):
            res = fused(feats, rows)
            return res if decode == "greedy" else pack_beam_result(res)
        return run

    def run_plain(feats, rows=None):
        # the plain decoders take one theta per row, not a bank
        theta = ({k: t[rows.long()] for k, t in gru_params.items()} if bank
                 else gru_params)
        if decode == "greedy":
            return greedy(decoder, feats, max_len=max_steps, gru_params=theta, device=device)
        return pack_beam_result(beam_search(decoder, feats, max_steps=max_steps,
                                            gru_params=theta, device=device))
    return run_plain


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--images", type=str, required=True,
                        help="image file or directory")
    parser.add_argument("--requests", type=str, default="",
                        help="JSONL of {'image': name, 'style': s} request "
                             "rows: serves arbitrary per-image styles in "
                             "ONE mixed-style stream (theta bank + "
                             "style_rows) instead of one pass per style")
    parser.add_argument("--out", type=str, default="captions.jsonl")
    parser.add_argument("--kind", type=str, default="hypernet",
                        choices=["gru", "hypernet"])
    parser.add_argument("--styles", type=str, default="factual")
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--decode", type=str, default="beam",
                        choices=["beam", "greedy"])
    parser.add_argument("--no-fused", action="store_true",
                        help="decode with the plain beam_search / greedy "
                             "instead of the K1 / K2 kernels (as on the CPU)")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    resolve_mesh(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    g_model, g_encoder = model_generators(train_cfg.seed)
    like = (build_captioner(model_cfg, vocab, g_model, device) if args.kind == "gru"
            else build_hypernet_model(model_cfg, vocab, g_model, device=device))
    try:
        params = restore_checkpoint(train_cfg.checkpoint_dir, like=like)
        print(f"loaded checkpoint from {train_cfg.checkpoint_dir}")
    except FileNotFoundError:
        params = like
        print("no checkpoint found; captioning with random-init weights")
    encoder = CNNEncoder(build_encoder(model_cfg, g_encoder, args.encoder_weights, device),
                         torch.bfloat16, device)

    def encode(imgs: np.ndarray) -> torch.Tensor:
        return encoder(preprocess_images(torch.from_numpy(imgs).to(device)))

    files = list(iter_image_files(args.images))
    if not files:
        raise SystemExit(f"no images found under {args.images}")
    B = min(train_cfg.batch_size, len(files))
    styles = args.styles.split(",")
    use_fused = not args.no_fused and device.type == "cuda"
    decoder = params["decoder"] if args.kind == "hypernet" else params

    with torch.no_grad():
        if args.requests:
            return _serve_requests(args, train_cfg, params, decoder, vocab, encode,
                                   use_fused, device)
        n_out = 0
        with open(args.out, "w") as out:
            for style in styles:
                theta = (synthesize_theta(params, resolve_style_id(params, vocab, style))
                         if args.kind == "hypernet" else None)
                server = PipelinedDecoder(_decode_fn(decoder, theta, args.decode,
                                                     train_cfg.beam_max_steps, use_fused,
                                                     device))

                def feature_batches():
                    for start in range(0, len(files), B):
                        chunk = files[start:start + B]
                        yield encode(_padded(native_image.load_paths_batch(chunk), B))

                i = 0
                for result in server.map(feature_batches()):
                    for row in _result_rows(result, args.decode, vocab):
                        if i >= len(files):  # padding rows of the last chunk
                            break
                        out.write(json.dumps({
                            "image": os.path.basename(files[i]),
                            "style": style, **row,
                        }) + "\n")
                        i += 1
                        n_out += 1
    print(f"wrote {n_out} captions for {len(files)} images "
          f"x {len(styles)} styles -> {args.out}")
    return n_out


def _serve_requests(args, train_cfg, params, decoder, vocab, encode, use_fused, device):
    """Mixed-style request serving: the JSONL rows {'image', 'style'} decode
    in ONE stream over a theta bank synthesized once, each row picking its
    style (``style_rows``)."""
    if args.kind != "hypernet":
        raise SystemExit("--requests needs --kind hypernet "
                         "(per-request styles come from the hypernet)")
    with open(args.requests) as f:
        reqs = [json.loads(line) for line in f if line.strip()]
    if not reqs:
        raise SystemExit(f"no request rows in {args.requests}")
    styles = sorted({r["style"] for r in reqs})
    sid = {s: i for i, s in enumerate(styles)}
    base = args.images if os.path.isdir(args.images) else os.path.dirname(args.images)

    def path_of(name):
        return name if os.path.isabs(name) else os.path.join(base, name)

    ids = torch.tensor([resolve_style_id(params, vocab, s) for s in styles], device=device)
    bank = synthesize_theta_batched(params, style_table(params)[ids])
    B = min(train_cfg.batch_size, len(reqs))
    server = PipelinedDecoder(_decode_fn(decoder, bank, args.decode, train_cfg.beam_max_steps,
                                         use_fused, device))

    def batches():
        for start in range(0, len(reqs), B):
            chunk = reqs[start:start + B]
            imgs = native_image.load_paths_batch([path_of(r["image"]) for r in chunk])
            rows = np.zeros((B,), np.int32)  # padding rows take style 0
            rows[:len(chunk)] = [sid[r["style"]] for r in chunk]
            yield encode(_padded(imgs, B)), torch.from_numpy(rows).to(device)

    n_out = 0
    with open(args.out, "w") as out:
        i = 0
        for result in server.map(batches()):
            for row in _result_rows(result, args.decode, vocab):
                if i >= len(reqs):  # padding rows of the last chunk
                    break
                out.write(json.dumps({
                    "image": os.path.basename(reqs[i]["image"]),
                    "style": reqs[i]["style"], **row,
                }) + "\n")
                i += 1
                n_out += 1
    print(f"wrote {n_out} captions for {len(reqs)} mixed-style requests "
          f"({len(styles)} styles in one stream) -> {args.out}")
    return n_out


if __name__ == "__main__":
    main()
