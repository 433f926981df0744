"""Train the hypernet on combined FlickrStyle + Conceptual Captions.

Port of ``captionax/cli/train_hyper_combine.py`` (the reference's
train_hyper_combine.py): the Flickr styles join the CC domains as the
pseudo-domains ``f``/``h``/``r`` (appended as zero-shot ids 100-102, so
``one hot`` is 103 wide); each batch is all Flickr or all CC; one
domain-conditioned hypernet serves all.  As in
captionax, the embedder is built with ``f``/``h``/``r`` as zero-shot
domains and no zero-shot file, so the histogram and JSD schemes raise
``FileNotFoundError`` at its construction.  Runs on the card unless
``--device cpu`` is given.

captionax's extensions beyond the reference recipe:
- ``--style-aux`` with ``--style-classifier``: the 4-class (f/h/r/CC)
  style-identification loss; the probe's class rides in
  ``batch['probe_cls']`` (``TrainConfig.style_aux_from_batch``);
- ``--mixup``: the reference's style mixup against the same probe;
- ``--select-sep-margin``: keep the epoch whose beam-decoded validation
  captions the frozen probe assigns to their conditioning's class with
  the highest mean probability, and test that checkpoint;
- ``--init-hn``: warm-start the hypernet from a ``.pkl`` holding
  ``{'hn': ...}`` (numpy arrays) or from a port checkpoint directory
  (``cli/train_init`` writes one).

``--mesh-data N`` trains data parallel on N ranks, one process each
(``parallel.launch``); rank 0 logs, writes the checkpoint and returns
the history, and with ``--select-sep-margin`` reads the selected
checkpoint and broadcasts it to the other ranks for the test.

    python -m captionax_torch.cli.train_hyper_combine --synthetic \\
        --domain-scheme "one hot" --max-epochs 2
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from captionax_torch.cli.cc_train_hypernet import attach_domain_values, domain_embed_fn
from captionax_torch.cli.common import (
    build_encoder,
    build_hypernet_model,
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
from captionax_torch.data.cc import ConceptualCaptionsData, domain_list, load_cc_captions
from captionax_torch.data.combine import CombinedData, style_histograms
from captionax_torch.data.domains import DomainEmbedder
from captionax_torch.data.synthetic import synthetic_image
from captionax_torch.decode.search import beam_search
from captionax_torch.interop import from_jax_params
from captionax_torch.models.classifiers import classifier_ids_apply_fn
from captionax_torch.models.hypernet import hypernet_apply
from captionax_torch.train.checkpoint import restore_checkpoint
from captionax_torch.train.harness import CaptionTrainer

# the probe's class of each pseudo-domain; any CC domain is class 3
PROBE_CLS = {"f": 0, "h": 1, "r": 2}
PROBE_T = 25  # the probe's trained caption length


def attach_probe_cls(batches):
    """Host side: label each batch with its 4-class probe class (f/h/r ->
    0/1/2, any CC domain -> 3) for the style-aux loss."""
    for batch in batches:
        batch = dict(batch)
        batch["probe_cls"] = np.int32(PROBE_CLS.get(batch["domain"], 3))
        yield batch


def probe_decode(params, embedder, features, domain_value, clf_params, beam_size: int,
                 max_steps: int, device) -> torch.Tensor:
    """The probe's class probabilities [B, C] of the beam captions of
    ``features`` under the conditioning ``domain_value``: the tokens after
    ``<s>``, padded or cut to the probe's 25, through the classifier (a
    softmax after the BERT kind, whose output is logits)."""
    with torch.no_grad():
        emb = embedder.embed(params["domain_emb"], domain_value)
        theta = hypernet_apply(params["hn"], emb)
        ids = beam_search(params["decoder"], features, k=beam_size, max_steps=max_steps,
                          gru_params=theta, device=device).tokens
        padded = torch.zeros((ids.shape[0], PROBE_T), dtype=torch.int32, device=ids.device)
        n = min(PROBE_T, ids.shape[1] - 1)
        padded[:, :n] = ids[:, 1:1 + n].to(torch.int32)
        out = classifier_ids_apply_fn(clf_params)(clf_params, padded)
        return out if "bert" not in clf_params else torch.softmax(out, dim=-1)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--style-classifier", type=str, default="",
                        help="pickled 4-class (f/h/r/CC) probe params "
                             "(cli/train_classifier --kind style4 --save, or a "
                             "small probe); required with --style-aux / --mixup / "
                             "--select-sep-margin")
    parser.add_argument("--init-hn", type=str, default="",
                        help="warm-start the hypernet: a .pkl holding "
                             "{'hn': ...} or a port checkpoint directory")
    parser.add_argument("--select-sep-margin", action="store_true",
                        help="checkpoint-select on the per-epoch validation "
                             "separation margin (the mean frozen-probe "
                             "probability of the true class over beam-decoded "
                             "validation captions under each conditioning); "
                             "requires --style-classifier")
    parser.add_argument("--sep-probe-images", type=int, default=192)
    parser.add_argument("--sep-cc-conds", type=int, default=2,
                        help="CC domains included as conditionings in the "
                             "selection monitor (plus f/h/r)")
    parser.add_argument("--sep-max-steps", type=int, default=20)
    args = parser.parse_args(argv)
    if ranks_to_start(args):
        return run_on_ranks(main, argv, args)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    mesh = resolve_mesh(args)
    device = mesh.local_device if mesh is not None else resolve_device(args.device)
    if train_cfg.style_aux:
        # the combined model's aux class is carried by the batch (4 classes)
        train_cfg.style_aux_from_batch = True
    if args.select_sep_margin:
        train_cfg.select_metric = "val_sep_margin"
        train_cfg.select_mode = "max"

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    flickr = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    rows = load_cc_captions(data_cfg.cc_captions)
    cc = ConceptualCaptionsData(rows, vocab, image_loader=synthetic_image,
                                max_len=train_cfg.max_len)
    combined = CombinedData(flickr, cc)
    cc_domains = domain_list(data_cfg.cc_captions)
    print(f"vocab={len(vocab)} flickr={len(flickr)} cc_rows={len(cc)} "
          f"domains={len(cc_domains)}+3 styles")

    embedder = DomainEmbedder(
        data_cfg.domain_scheme, vocab, cc_domains,
        hyper_emb=model_cfg.hyper_emb, cap_path=data_cfg.cc_captions,
        n_tsne=data_cfg.n_tsne,
        zero_shot_domains=list("fhr"),  # the styles appended as zero-shot ids
    )
    if data_cfg.domain_scheme.startswith("histograme"):
        embedder.table.update(
            {k: np.asarray(v, np.float32)
             for k, v in style_histograms(flickr, vocab).items()}
        )

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_hypernet_model(model_cfg, vocab, g_model,
                                  hyper_emb=embedder.hyper_emb, device=device)
    params["domain_emb"] = embedder.init_params(g_model, device)
    params = maybe_load_glove(params, data_cfg, vocab, model_cfg.embed_size)
    if args.init_hn:
        if args.init_hn.endswith(".pkl"):
            with open(args.init_hn, "rb") as f:
                params["hn"] = from_jax_params(pickle.load(f)["hn"], device)
        else:
            params["hn"] = restore_checkpoint(args.init_hn, like=params)["hn"]
        print(f"hypernet warm-started from {args.init_hn}")
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)
    embed_fn = domain_embed_fn(embedder)

    clf_params = None
    if train_cfg.mixup or train_cfg.style_aux or args.select_sep_margin:
        if not args.style_classifier:
            raise SystemExit("--mixup/--style-aux/--select-sep-margin require "
                             "--style-classifier")
        with open(args.style_classifier, "rb") as f:
            clf_params = from_jax_params(pickle.load(f), device)

    trainer = CaptionTrainer(
        params, "hypernet", train_cfg, vocab,
        encoder_params=encoder_params, embed_fn=embed_fn,
        run_name=args.run_name, mesh=mesh, device=device,
        style_classifier_params=clf_params,
    )
    if args.resume:
        resumed = trainer.maybe_resume(args.resume if args.resume != "auto" else None)
        print(f"resumed={resumed}")
    fl_train, fl_val, fl_test = flickr.splits(seed=train_cfg.seed)
    cc_train, cc_val, cc_test = cc.split_by_domain(2, 2, seed=train_cfg.seed)

    sep_hook = None
    if args.select_sep_margin:
        # tiny datasets may have an empty val split: fall back to train
        probe_idx = (list(fl_val) or list(fl_train))[: args.sep_probe_images]
        probe_imgs = np.stack([flickr.image(i) for i in probe_idx])
        probe_feats = trainer._encode(encoder_params, probe_imgs)
        cc_pick = cc_domains[:: max(1, len(cc_domains)
                                    // max(args.sep_cc_conds, 1))][: args.sep_cc_conds]
        conds = [("f", 0), ("h", 1), ("r", 2)] + [(d, 3) for d in cc_pick]

        def sep_hook(p):
            true_prob, correct, total = 0.0, 0, 0
            for dom, cls in conds:
                dv = torch.as_tensor(np.asarray(embedder.host_vector(dom))).to(trainer.device)
                probs = probe_decode(p, embedder, probe_feats, dv, clf_params,
                                     train_cfg.beam_size, args.sep_max_steps,
                                     trainer.device).cpu().numpy()
                true_prob += float(probs[:, cls].sum())
                correct += int((probs.argmax(-1) == cls).sum())
                total += len(probs)
            return {"val_sep_margin": true_prob / max(total, 1),
                    "val_sep_acc": correct / max(total, 1)}

    history = trainer.fit(
        lambda epoch: attach_probe_cls(attach_domain_values(
            combined.batches(train_cfg.batch_size, seed=train_cfg.seed + epoch,
                             flickr_indices=fl_train, cc_indices=cc_train),
            embedder,
        )),
        lambda: attach_probe_cls(attach_domain_values(
            combined.batches(train_cfg.batch_size, seed=train_cfg.seed,
                             flickr_indices=fl_val, cc_indices=cc_val),
            embedder,
        )),
        epoch_end_metrics=sep_hook,
    )
    if args.select_sep_margin:
        # test the SELECTED checkpoint, not the last epoch's params
        trainer.restore_params(train_cfg.checkpoint_dir)
        print(f"selected checkpoint val_sep_margin={-trainer.checkpointer.best:.4f}")
    res = trainer.test_beam(
        attach_probe_cls(attach_domain_values(
            combined.batches(train_cfg.batch_size, seed=0,
                             flickr_indices=fl_test, cc_indices=cc_test,
                             drop_remainder=False),
            embedder,
        ))
    )
    trainer.logger.log({f"test_{k}": v for k, v in res.items()})
    print({k: round(v, 4) for k, v in res.items()})
    return history


if __name__ == "__main__":
    main()
