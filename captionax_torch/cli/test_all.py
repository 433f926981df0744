"""Evaluate a combined model over all five test sets.

Port of ``captionax/cli/test_all.py`` (the reference's test_all.py):
beam-test a (combined) hypernet over the factual, humour and romantic
Flickr styles, the CC test split and the CC zero-shot domains of
``--cc-oneshot-captions``.  The embedder is built exactly as
``train_hyper_combine`` builds it, so that the checkpoint restores; for
``one hot`` and ``embedding`` the unseen domains are registered after the
restore (a ``one hot`` id past the trained width embeds as the zero row;
an ``embedding`` row is drawn fresh), and the histogram and JSD schemes
take them at construction.  Runs on the card unless ``--device cpu`` is
given.

``--mesh-data`` is accepted and ignored: this CLI runs on one device,
as captionax's does.

    python -m captionax_torch.cli.test_all --synthetic --checkpoint-dir ckpts
"""

from __future__ import annotations

import os

from captionax_torch.cli.cc_train_hypernet import attach_domain_values, domain_embed_fn
from captionax_torch.cli.common import (
    build_encoder,
    build_hypernet_model,
    make_parser,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data.cc import ConceptualCaptionsData, domain_list, load_cc_captions
from captionax_torch.data.combine import FLICKR_PSEUDO_DOMAINS
from captionax_torch.data.domains import DomainEmbedder
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
    flickr = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    rows = load_cc_captions(data_cfg.cc_captions)
    cc = ConceptualCaptionsData(rows, vocab, image_loader=synthetic_image,
                                max_len=train_cfg.max_len)
    cc_domains = domain_list(data_cfg.cc_captions)
    zero_shot = (
        domain_list(data_cfg.cc_oneshot_captions)
        if os.path.exists(data_cfg.cc_oneshot_captions) else []
    )

    # the embedder EXACTLY as train_hyper_combine builds it (the styles as
    # zero-shot ids, the CC zero-shot domains left out) so that the
    # checkpoint's shapes match; the unseen domains are registered after
    # the restore for the id-table schemes
    id_scheme = data_cfg.domain_scheme in ("embedding", "one hot")
    embedder = DomainEmbedder(
        data_cfg.domain_scheme, vocab, cc_domains,
        hyper_emb=model_cfg.hyper_emb, cap_path=data_cfg.cc_captions,
        n_tsne=data_cfg.n_tsne,
        zero_shot_domains=list("fhr") + ([] if id_scheme else zero_shot),
        zero_shot_path=data_cfg.cc_oneshot_captions,
    )
    # the generators of a run with seed 0, as captionax takes PRNGKey(0)
    g_model, g_encoder = model_generators(0)
    params = build_hypernet_model(model_cfg, vocab, g_model,
                                  hyper_emb=embedder.hyper_emb, device=device)
    params["domain_emb"] = embedder.init_params(g_model, device)
    try:
        params = restore_checkpoint(train_cfg.checkpoint_dir, like=params)
        print(f"loaded {train_cfg.checkpoint_dir}")
    except FileNotFoundError:
        print("no checkpoint; evaluating random init")
    if zero_shot and id_scheme:
        params = dict(params)
        params["domain_emb"] = embedder.register_zero_shot(
            params["domain_emb"], zero_shot, g_model)
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)
    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, embed_fn=domain_embed_fn(embedder),
        run_name=args.run_name + "_all", device=device,
    )

    _, _, fl_test = flickr.splits(seed=train_cfg.seed)
    _, _, cc_test = cc.split_by_domain(2, 2, seed=train_cfg.seed)
    results = {}

    def flickr_with_domains(style):
        for b in flickr.batches(fl_test, train_cfg.batch_size, style=style,
                                seed=0, shuffle=False, drop_remainder=False):
            b["domain"] = FLICKR_PSEUDO_DOMAINS[style]
            yield b

    for style in ("factual", "humour", "romantic"):
        results[style] = trainer.test_beam(
            attach_domain_values(flickr_with_domains(style), embedder)
        )
    results["cc"] = trainer.test_beam(
        attach_domain_values(
            cc.batches(train_cfg.batch_size, seed=0, indices=cc_test,
                       drop_remainder=False),
            embedder,
        )
    )
    if zero_shot:
        zs = ConceptualCaptionsData(
            load_cc_captions(data_cfg.cc_oneshot_captions), vocab,
            image_loader=synthetic_image, max_len=train_cfg.max_len,
        )
        results["cc_zero_shot"] = trainer.test_beam(
            attach_domain_values(
                zs.batches(train_cfg.batch_size, seed=0, drop_remainder=False),
                embedder,
            )
        )
    for name, res in results.items():
        print(name, {k: round(v, 4) for k, v in res.items()})
    return results


if __name__ == "__main__":
    main()
