"""Train the Conceptual Captions domain-conditioned hypernet.

Port of ``captionax/cli/cc_train_hypernet.py`` (the reference's
cc_train_hypernet.py): domain-homogeneous batches, one of six
domain-embedding schemes (``data/domains.py``) conditioning the hypernet,
zero-shot domains tested with ``cli/test_zero_shot``.  Images are read
from the caption file's directory (gray files through the viridis LUT
before the resize), or made from their names with ``--synthetic``.  Runs
on the card unless ``--device cpu`` is given; ``--fused-scan`` runs the
teacher-forced recurrence on K3, and the frozen encoder runs on K4.

``--mesh-data N`` trains data parallel on N ranks, one process each
(``parallel.launch``); rank 0 logs, writes the checkpoint and returns
the history.

    python -m captionax_torch.cli.cc_train_hypernet --synthetic \\
        --domain-scheme "histograme log" --max-epochs 2
"""

from __future__ import annotations

import os

import numpy as np
import torch

from captionax_torch.cli.common import (
    build_encoder,
    build_hypernet_model,
    make_parser,
    maybe_load_glove,
    model_generators,
    parse_configs,
    ranks_to_start,
    resolve_mesh,
    resolve_vocab,
    run_on_ranks,
)
from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.data.cc import ConceptualCaptionsData, domain_list, load_cc_captions
from captionax_torch.data.domains import DomainEmbedder
from captionax_torch.data.synthetic import synthetic_image
from captionax_torch.train.harness import CaptionTrainer


def attach_domain_values(batches, embedder):
    """Host side: the batch's domain name -> the value the step embeds
    (an id, or a histogram or t-SNE vector), as ``batch['domain_value']``."""
    for batch in batches:
        batch = dict(batch)
        batch["domain_value"] = np.asarray(embedder.host_vector(batch["domain"]))
        yield batch


def domain_embed_fn(embedder):
    """The trainer's ``embed_fn``: the batch's domain through the
    embedder's trainable part, ``params['domain_emb']``."""
    return lambda p, b: embedder.embed(p["domain_emb"], b["domain_value"])


def build_cc_model_and_embedder(model_cfg, data_cfg, vocab, generator: torch.Generator,
                                zero_shot_domains=(), device: DeviceLike = None):
    """-> (the hypernet model with its ``domain_emb``, the embedder, the
    trainer's ``embed_fn``); the weights are drawn from ``generator``, the
    hypernet's first, and placed on ``device``."""
    dev = resolve_device(device)
    domains = domain_list(data_cfg.cc_captions)
    embedder = DomainEmbedder(
        data_cfg.domain_scheme, vocab, domains,
        hyper_emb=model_cfg.hyper_emb, cap_path=data_cfg.cc_captions,
        n_tsne=data_cfg.n_tsne,
        zero_shot_domains=zero_shot_domains,
        zero_shot_path=data_cfg.cc_oneshot_captions,
    )
    params = build_hypernet_model(model_cfg, vocab, generator, hyper_emb=embedder.hyper_emb,
                                  device=dev)
    params["domain_emb"] = embedder.init_params(generator, dev)
    return params, embedder, domain_embed_fn(embedder)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--encoder-weights", type=str, default="",
                        help="torchvision resnet state_dict (.pt) to fold")
    args = parser.parse_args(argv)
    if ranks_to_start(args):
        return run_on_ranks(main, argv, args)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = mesh.local_device if mesh is not None else resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    rows = load_cc_captions(data_cfg.cc_captions)
    image_loader = synthetic_image if data_cfg.synthetic else None
    if image_loader is None:
        from captionax_torch.data.native_image import GRAY_VIRIDIS, make_file_loader

        # gray -> viridis inside the decoder, before the resize (the
        # reference's order)
        image_loader = make_file_loader(os.path.dirname(data_cfg.cc_captions),
                                        gray_mode=GRAY_VIRIDIS)
    data = ConceptualCaptionsData(rows, vocab, image_loader=image_loader,
                                  max_len=train_cfg.max_len)
    print(f"vocab={len(vocab)} rows={len(data)} domains={len(data.domains)} "
          f"scheme={data_cfg.domain_scheme!r}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params, embedder, embed_fn = build_cc_model_and_embedder(
        model_cfg, data_cfg, vocab, g_model, device=device
    )
    params = maybe_load_glove(params, data_cfg, vocab, model_cfg.embed_size)
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)

    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, embed_fn=embed_fn,
        run_name=args.run_name, mesh=mesh, device=device,
    )
    if args.resume:
        resumed = trainer.maybe_resume(args.resume if args.resume != "auto" else None)
        print(f"resumed={resumed}")
    train_idx, val_idx, test_idx = data.split_by_domain(2, 2, seed=train_cfg.seed)
    history = trainer.fit(
        lambda epoch: attach_domain_values(
            data.batches(train_cfg.batch_size, seed=train_cfg.seed + epoch,
                         indices=train_idx),
            embedder,
        ),
        lambda: attach_domain_values(
            data.batches(train_cfg.batch_size, seed=train_cfg.seed,
                         indices=val_idx, drop_remainder=False),
            embedder,
        ),
    )
    res = trainer.test_beam(
        attach_domain_values(
            data.batches(train_cfg.batch_size, seed=0, indices=test_idx,
                         drop_remainder=False),
            embedder,
        )
    )
    trainer.logger.log({f"test_{k}": v for k, v in res.items()})
    print({k: round(v, 4) for k, v in res.items()})
    return history


if __name__ == "__main__":
    main()
