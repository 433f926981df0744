"""Serve styled captions over HTTP from a checkpoint.

Port of ``captionax/cli/serve.py``: every concurrent request coalesces
through one MicroBatcher into fixed-shape dispatches of images ->
ResNet-152 (bf16 with its stride-1 chains on K4, or int8 with
``--int8-encoder``) -> the beam decode on K1 (greedy: K2) on the card
(``captionax_torch/decode/service.py``).  ``--rss-limit-mb`` runs the
server in worker processes that a supervisor rolls, handing the listening
socket from one to the next without dropping a request
(``captionax_torch/decode/supervise.py``).

    python -m captionax_torch.cli.serve --checkpoint-dir ckpt \\
        --kind hypernet --styles factual,humour,romantic --port 8080

    curl -X POST --data-binary @dog.jpg -H 'Content-Type: image/jpeg' \\
        'http://localhost:8080/caption?style=humour'

Runs on the card unless ``--device cpu`` is given.  ``--mesh-data N``
shards each dispatch over N mesh slots of the device in one process (a
one-card machine repeats its card): each shard runs the encoder (K4) and
the decode on K1 (greedy: K2), as one device does.  Only ``--no-fused``
decodes on the plain ``beam_search`` / ``greedy``.  (captionax's serve
turns its fused decode off whenever a mesh is given; the port does not
follow it there, since its kernels run on every shard.)
"""

from __future__ import annotations

import argparse
import sys

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


def build_service(args):
    """Construct the CaptionService from CLI args (shared with tests)."""
    from captionax_torch.decode.service import CaptionService
    from captionax_torch.train.checkpoint import restore_checkpoint

    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = mesh.data_devices[0] if mesh is not None else resolve_device(args.device)
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
        print("no checkpoint found; serving random-init weights")
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)
    return CaptionService(
        params, encoder_params, vocab,
        styles=args.styles.split(","),
        batch_size=args.window,
        max_steps=train_cfg.beam_max_steps,
        use_fused=False if args.no_fused else None,
        decode=args.decode,
        mesh=mesh,
        int8_encoder=args.int8_encoder,
        device=device,
    )


def make_serve_parser(doc=None):
    """The full serve flag surface, in one place (tests build their service
    args from it too)."""
    parser = make_parser(doc or __doc__)
    parser.add_argument("--kind", type=str, default="hypernet",
                        choices=["gru", "hypernet"])
    parser.add_argument("--styles", type=str, default="factual")
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--decode", type=str, default="beam",
                        choices=["beam", "greedy"])
    parser.add_argument("--no-fused", action="store_true")
    parser.add_argument("--int8-encoder", action="store_true",
                        help="serve with the int8 encoder: the frozen ResNet's "
                             "bottleneck convs quantized to int8 per output "
                             "channel, with activation scales calibrated when "
                             "the server starts (models/encoder.py "
                             "resnet_quantize); the stem stays unquantized")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--window", type=int, default=64,
                        help="MicroBatcher batch (the coalescing window; "
                             "requests/dispatch ceiling)")
    parser.add_argument("--rss-limit-mb", type=float, default=0.0,
                        help="supervise the server in a worker subprocess "
                             "and roll it (hitless shared-listener "
                             "handover: one kernel accept queue across "
                             "worker generations) when its host RSS crosses "
                             "this bound (decode/supervise.py; 0 = off)")
    parser.add_argument("--prearm-frac", type=float, default=0.8,
                        help="spawn the replacement worker at this "
                             "fraction of --rss-limit-mb so the switch at "
                             "the limit is immediate")
    parser.add_argument("--drain-grace", type=float, default=10.0,
                        help="seconds a retiring worker keeps running its "
                             "in-flight handler threads after SIGTERM")
    parser.add_argument("--_worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--listen-fd", type=int, default=-1, help=argparse.SUPPRESS)
    parser.add_argument("--standby", action="store_true", help=argparse.SUPPRESS)
    return parser


def _warmup(service):
    """One request before the listener opens, so that a replacement worker
    is hot (kernels loaded, first dispatch paid) when it takes traffic."""
    import numpy as np

    service.caption_array(
        np.zeros((service.image_size, service.image_size, 3), np.uint8),
        service.styles[0],
    )


def main(argv=None):
    args = make_serve_parser().parse_args(argv)

    if args.rss_limit_mb > 0 and not args._worker:
        # SUPERVISOR: run the actual server in a recyclable subprocess
        from captionax_torch.decode.supervise import RssSupervisor

        if args.port == 0:
            raise SystemExit("--rss-limit-mb needs a fixed --port "
                             "(the supervisor binds it once and workers "
                             "inherit the listening fd)")
        base = list(argv) if argv is not None else sys.argv[1:]
        sup = RssSupervisor(
            [sys.executable, "-m", "captionax_torch.cli.serve", *base, "--_worker"],
            args.rss_limit_mb,
            listen_host=args.host, listen_port=args.port,
            prearm_frac=args.prearm_frac,
        )
        print(f"supervising serve workers on :{args.port} "
              f"(rss limit {args.rss_limit_mb:.0f} MB)", flush=True)
        sup.run()
        return

    if args._worker:
        from captionax_torch.decode.supervise import run_worker

        service = build_service(args)
        run_worker(service, args.host, args.port,
                   drain_grace_s=args.drain_grace, warmup=_warmup,
                   listen_fd=args.listen_fd if args.listen_fd >= 0 else None,
                   standby=args.standby)
        return

    from captionax_torch.decode.service import make_http_server

    with build_service(args) as service:
        srv = make_http_server(service, args.host, args.port)
        host, port = srv.server_address[:2]
        print(f"serving {service.styles} on http://{host}:{port} "
              f"(POST /caption, GET /healthz)", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()


if __name__ == "__main__":
    main()
