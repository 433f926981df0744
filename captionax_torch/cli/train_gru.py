"""Train the plain attention-GRU captioner (single style).

Port of ``captionax/cli/train_gru.py`` (the reference's
train_attention_gru.py): fixed-style batches (default factual), CE loss,
plateau LR, top-1 checkpoint, beam test.  Runs on the card unless
``--device cpu`` is given.

``--mesh-data N`` trains data parallel on N ranks, one process each
(``parallel.launch``); rank 0 logs, writes the checkpoint and returns
the history.

    python -m captionax_torch.cli.train_gru --synthetic --max-epochs 2
"""

from __future__ import annotations

from captionax_torch.cli.common import (
    build_captioner,
    build_encoder,
    make_parser,
    maybe_load_glove,
    model_generators,
    parse_configs,
    ranks_to_start,
    resolve_flickr_data,
    resolve_mesh,
    resolve_vocab,
    run_on_ranks,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.train.harness import CaptionTrainer


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--style", type=str, default="factual",
                        choices=["factual", "humour", "romantic"])
    parser.add_argument("--encoder-weights", type=str, default="")
    args = parser.parse_args(argv)
    if ranks_to_start(args):
        return run_on_ranks(main, argv, args)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = mesh.local_device if mesh is not None else resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    print(f"vocab={len(vocab)} images={len(data)} style={args.style}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_captioner(model_cfg, vocab, g_model, device)
    params = maybe_load_glove({"decoder": params}, data_cfg, vocab,
                              model_cfg.embed_size)["decoder"]
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    trainer = CaptionTrainer(
        params, "gru", train_cfg, vocab,
        encoder_params=encoder_params, run_name=args.run_name,
        mesh=mesh, device=device,
    )
    if args.resume:
        resumed = trainer.maybe_resume(args.resume if args.resume != "auto" else None)
        print(f"resumed={resumed}")
    train_idx, val_idx, test_idx = data.splits(seed=train_cfg.seed)
    history = trainer.fit(
        lambda epoch: data.batches(
            train_idx, train_cfg.batch_size, style=args.style,
            seed=train_cfg.seed + epoch,
        ),
        lambda: data.batches(
            val_idx, train_cfg.batch_size, style=args.style,
            seed=train_cfg.seed, shuffle=False, drop_remainder=False,
        ),
    )
    res = trainer.test_beam(
        data.batches(test_idx, train_cfg.batch_size, style=args.style,
                     seed=0, shuffle=False, drop_remainder=False)
    )
    trainer.logger.log({f"test_{k}": v for k, v in res.items()})
    print({k: round(v, 4) for k, v in res.items()})
    return history


if __name__ == "__main__":
    main()
