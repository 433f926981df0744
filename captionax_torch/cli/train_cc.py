"""Train the URL-streaming CC hypernet.

Port of ``captionax/cli/train_cc.py`` (the reference's train_cc.py): GCC
TSV rows (``--gcc-tsv``), domains fixed to the nine hosting sites of
``data/cc_stream.DEFAULT_SITES`` under a ``one hot`` embedder, images
fetched per row in the loader's thread.  ``--fetch`` fetches over HTTP and
needs network access; without it every image is a deterministic
placeholder.  Runs on the card unless ``--device cpu`` is given.

``--mesh-data N`` trains data parallel on N ranks, one process each
(``parallel.launch``); rank 0 logs, writes the checkpoint and returns
the history.

    python -m captionax_torch.cli.train_cc --gcc-tsv data/gcc.tsv --max-epochs 1
"""

from __future__ import annotations

from captionax_torch.cli.cc_train_hypernet import attach_domain_values, domain_embed_fn
from captionax_torch.cli.common import (
    build_encoder,
    build_hypernet_model,
    make_parser,
    model_generators,
    parse_configs,
    ranks_to_start,
    resolve_mesh,
    resolve_vocab,
    run_on_ranks,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data.cc_stream import (
    DEFAULT_SITES,
    StreamingCC,
    http_fetcher,
    load_gcc_tsv,
)
from captionax_torch.data.domains import DomainEmbedder
from captionax_torch.train.harness import CaptionTrainer


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--gcc-tsv", type=str, required=True)
    parser.add_argument("--fetch", action="store_true",
                        help="fetch images over HTTP (needs network access)")
    parser.add_argument("--limit", type=int, default=5000)
    parser.add_argument("--encoder-weights", type=str, default="")
    args = parser.parse_args(argv)
    if ranks_to_start(args):
        return run_on_ranks(main, argv, args)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = mesh.local_device if mesh is not None else resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    rows = load_gcc_tsv(args.gcc_tsv, limit=args.limit)
    data = StreamingCC(
        rows, vocab,
        fetcher=http_fetcher() if args.fetch else None,
        max_len=train_cfg.max_len,
    )
    print(f"vocab={len(vocab)} rows={len(rows)} "
          f"domains={sorted(data.by_domain)} fetch={args.fetch}")

    embedder = DomainEmbedder("one hot", vocab, list(DEFAULT_SITES),
                              hyper_emb=model_cfg.hyper_emb)
    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_hypernet_model(model_cfg, vocab, g_model,
                                  hyper_emb=embedder.hyper_emb, device=device)
    params["domain_emb"] = embedder.init_params(g_model, device)
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, embed_fn=domain_embed_fn(embedder),
        run_name=args.run_name, mesh=mesh, device=device,
    )
    if args.resume:
        resumed = trainer.maybe_resume(args.resume if args.resume != "auto" else None)
        print(f"resumed={resumed}")
    history = trainer.fit(
        lambda epoch: attach_domain_values(
            data.batches(train_cfg.batch_size, seed=train_cfg.seed + epoch),
            embedder,
        ),
        None,
    )
    print("done:", {k: round(v["train_loss_epoch"], 4) for k, v in history.items()})
    return history


if __name__ == "__main__":
    main()
