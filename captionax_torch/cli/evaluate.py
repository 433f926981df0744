"""Evaluate a trained checkpoint with beam search.

Port of ``captionax/cli/evaluate.py`` (the reference's test_hn /
test_gru): restore the latest checkpoint under ``--checkpoint-dir`` (the
port's format, ``train/checkpoint.py``), rebuild the encoder the training
run drew, and beam-test each style.  Runs on the card unless
``--device cpu`` is given.

``--mesh-data`` is accepted and ignored: this CLI runs on one device,
as captionax's does.

    python -m captionax_torch.cli.evaluate --checkpoint-dir ckpts --kind hypernet \\
        --synthetic
"""

from __future__ import annotations

from captionax_torch.cli.common import (
    build_captioner,
    build_encoder,
    build_hypernet_model,
    make_parser,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.train.checkpoint import restore_checkpoint
from captionax_torch.train.harness import CaptionTrainer
from captionax_torch.train.steps import dedicated_style_embed, style_token_embed


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--kind", type=str, default="hypernet",
                        choices=["gru", "hypernet"])
    parser.add_argument("--styles", type=str,
                        default="factual,humour,romantic")
    parser.add_argument("--encoder-weights", type=str, default="")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    data.dedicated_style_tokens = model_cfg.dedicated_style_tokens

    # the training run's generators: the encoder comes out the same
    g_model, g_encoder = model_generators(train_cfg.seed)
    like = (
        build_captioner(model_cfg, vocab, g_model, device)
        if args.kind == "gru"
        else build_hypernet_model(model_cfg, vocab, g_model, device=device)
    )
    params = restore_checkpoint(train_cfg.checkpoint_dir, like=like)
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    trainer = CaptionTrainer(
        params, args.kind, train_cfg, vocab,
        encoder_params=encoder_params, run_name=args.run_name + "_eval",
        device=device,
        embed_fn=dedicated_style_embed if model_cfg.dedicated_style_tokens
        else style_token_embed,
    )
    _, _, test_idx = data.splits(seed=train_cfg.seed)
    results = {}
    for style in args.styles.split(","):
        res = trainer.test_beam(
            data.batches(test_idx, train_cfg.batch_size, style=style,
                         seed=0, shuffle=False, drop_remainder=False)
        )
        results[style] = res
        print(style, {k: round(v, 4) for k, v in res.items()})
    return results


if __name__ == "__main__":
    main()
