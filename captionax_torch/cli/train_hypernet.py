"""Train the FlickrStyle hypernet captioner.

Port of ``captionax/cli/train_hypernet.py`` (the reference's
hypernet_attention.py): random per-batch style, CE on teacher-forced
logits, plateau LR on TF val loss, top-1 checkpoint, then beam-search test
per style.  Runs on the card unless ``--device cpu`` is given;
``--fused-scan`` runs the teacher-forced recurrence on K3.  ``--mixup`` or
``--style-aux`` adds a style loss scored by the frozen classifier that
``--style-classifier`` names (a pickle of numpy arrays, as
``cli/train_classifier --save`` writes it in either package).

    python -m captionax_torch.cli.train_hypernet --synthetic --max-epochs 2
"""

from __future__ import annotations

import pickle

from captionax_torch.cli.common import (
    build_encoder,
    build_hypernet_model,
    make_parser,
    maybe_load_glove,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_mesh,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.interop import from_jax_params
from captionax_torch.train.harness import CaptionTrainer
from captionax_torch.train.steps import dedicated_style_embed, style_token_embed


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--encoder-weights", type=str, default="",
                        help="torchvision resnet state_dict (.pt) to fold")
    parser.add_argument("--style-classifier", type=str, default="",
                        help="pickled style classifier params, small OR bert "
                             "(cli/train_classifier --kind small|style3 --save); "
                             "the probe kind is read from the params; required "
                             "with --mixup / --style-aux")
    parser.add_argument("--init-hn", type=str, default="",
                        help="warm-start the hypernet from the 'hn' subtree of "
                             "a port checkpoint directory (the reference's "
                             "pretrain-then-finetune flow)")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    data.dedicated_style_tokens = model_cfg.dedicated_style_tokens
    print(f"vocab={len(vocab)} images={len(data)}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_hypernet_model(model_cfg, vocab, g_model, device=device)
    params = maybe_load_glove(params, data_cfg, vocab, model_cfg.embed_size)
    if args.init_hn:
        # only the hn is distilled; the decoder keeps this run's init
        from captionax_torch.train.checkpoint import restore_checkpoint

        params["hn"] = restore_checkpoint(args.init_hn, like=params)["hn"]
        print(f"hypernet warm-started from {args.init_hn}")
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    clf_params = None
    if train_cfg.mixup or train_cfg.style_aux:
        if not args.style_classifier:
            raise SystemExit("--mixup/--style-aux require --style-classifier")
        with open(args.style_classifier, "rb") as f:
            clf_params = from_jax_params(pickle.load(f), device)

    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, run_name=args.run_name,
        style_classifier_params=clf_params,
        mesh=mesh, device=device,
        embed_fn=dedicated_style_embed if model_cfg.dedicated_style_tokens
        else style_token_embed,
    )
    if args.resume:
        resumed = trainer.maybe_resume(args.resume if args.resume != "auto" else None)
        print(f"resumed={resumed}")
    train_idx, val_idx, test_idx = data.splits(seed=train_cfg.seed)

    history = trainer.fit(
        lambda epoch: data.batches(
            train_idx, train_cfg.batch_size, style="random",
            seed=train_cfg.seed + epoch,
        ),
        lambda: data.batches(
            val_idx, train_cfg.batch_size, style="random",
            seed=train_cfg.seed, shuffle=False, drop_remainder=False,
        ),
    )
    # per-style beam test, mirroring the reference's three test loaders
    for style in ("factual", "humour", "romantic"):
        res = trainer.test_beam(
            data.batches(
                test_idx, train_cfg.batch_size, style=style,
                seed=0, shuffle=False, drop_remainder=False,
            )
        )
        trainer.logger.log({f"test_{style}_{k}": v for k, v in res.items()})
        print(style, {k: round(v, 4) for k, v in res.items()})
    return history


if __name__ == "__main__":
    main()
