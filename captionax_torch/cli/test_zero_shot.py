"""Zero-shot domain-transfer evaluation.

Port of ``captionax/cli/test_zero_shot.py`` (the reference's
test_zero_shot.py): rebuild the CC hypernet with the one-shot file's
domains added as zero-shot domains, restore the checkpoint under
``--checkpoint-dir`` (the port's format), and beam-test over those unseen
domains.  The histogram and JSD schemes embed any domain through their
MLP; for ``one hot`` and ``embedding`` the added domains change the
model's shapes, so the restore of a ``cc_train_hypernet`` checkpoint
raises, as it does in captionax (``test_all`` registers such domains after
the restore instead).  Images are made from their names with
``--synthetic``; otherwise the batches carry none, as in captionax.  Runs
on the card unless ``--device cpu`` is given.

``--mesh-data`` is accepted and ignored: this CLI runs on one device,
as captionax's does.

    python -m captionax_torch.cli.test_zero_shot --synthetic \\
        --domain-scheme "histograme log" --checkpoint-dir ckpts \\
        --cc-oneshot-captions data/one_shot_captions.txt
"""

from __future__ import annotations

from captionax_torch.cli.cc_train_hypernet import (
    attach_domain_values,
    build_cc_model_and_embedder,
)
from captionax_torch.cli.common import (
    build_encoder,
    make_parser,
    model_generators,
    parse_configs,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data.cc import ConceptualCaptionsData, domain_list, load_cc_captions
from captionax_torch.data.synthetic import synthetic_image
from captionax_torch.train.checkpoint import restore_checkpoint
from captionax_torch.train.harness import CaptionTrainer


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--encoder-weights", type=str, default="")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    zero_shot_domains = domain_list(data_cfg.cc_oneshot_captions)
    print(f"zero-shot domains: {zero_shot_domains}")

    # the generators of a run with seed 0, as captionax takes PRNGKey(0)
    g_model, g_encoder = model_generators(0)
    params, embedder, embed_fn = build_cc_model_and_embedder(
        model_cfg, data_cfg, vocab, g_model, zero_shot_domains=zero_shot_domains,
        device=device,
    )
    try:
        params = restore_checkpoint(train_cfg.checkpoint_dir, like=params)
    except FileNotFoundError:
        print("no checkpoint found; evaluating the random-init model")
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    rows = load_cc_captions(data_cfg.cc_oneshot_captions)
    data = ConceptualCaptionsData(
        rows, vocab,
        image_loader=synthetic_image if data_cfg.synthetic else None,
        max_len=train_cfg.max_len,
    )
    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, embed_fn=embed_fn,
        run_name=args.run_name + "_zeroshot", device=device,
    )
    res = trainer.test_beam(
        attach_domain_values(
            data.batches(train_cfg.batch_size, seed=0, drop_remainder=False),
            embedder,
        )
    )
    print({k: round(v, 4) for k, v in res.items()})
    return res


if __name__ == "__main__":
    main()
