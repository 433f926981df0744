"""Train the style and domain caption classifiers.

Port of ``captionax/cli/train_classifier.py``; runs on the card unless
``--device cpu`` is given.  The kinds:
- ``--kind style3``: the BERT classifier, factual / humour / romantic;
- ``--kind style4``: the same with a fourth class, Conceptual Captions text
  (``--cc-captions``);
- ``--kind domain``: one class per CC domain;
- ``--kind small``: the embedding + linear classifier;
- ``--kind essence``: the siamese same-image pair classifier.

The BERT trunk is randomly initialised, read from a HuggingFace state
dict (``--bert-weights``), or warm-started from the trunk of a classifier
saved earlier (``--warm-start``).  Every kind reports its accuracy on a
held-out tenth (by image for the styles, by row for the domains).  The
data order is captionax's: the split from ``random.Random(seed)`` /
``RandomState(seed)``, the batches from ``random.Random(1)`` (the last,
short batch of an epoch is dropped).  ``--save`` writes the trained params
as a pickle of numpy arrays, the file captionax's ``--save`` writes, which
``train_hypernet --style-classifier`` of either package reads.

    python -m captionax_torch.cli.train_classifier --kind small --synthetic --device cpu
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np
import torch

from captionax_torch.cli.common import (
    make_parser,
    parse_configs,
    resolve_flickr_data,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data.cc import load_cc_captions
from captionax_torch.data.flickr import STYLE_NAMES
from captionax_torch.interop import from_jax_params, to_numpy_tree
from captionax_torch.models.classifiers import (
    STYLE_LABELS,
    bert_trunk_from_hf_state_dict,
    essence_classifier_apply,
    essence_classifier_init,
    small_style_classifier_apply,
    small_style_classifier_init,
    style_classifier_apply,
    style_classifier_init,
)
from captionax_torch.train.logging import MetricLogger
from captionax_torch.train.state import create_train_state, make_optimizer, tree_map
from captionax_torch.train.steps import _value_and_grad


def _style_examples(data, indices, rng):
    """(ids [T], label) pairs across the three styles."""
    for i in indices:
        for style in STYLE_NAMES:
            yield data.caption_ids(style, i, rng=rng), STYLE_LABELS[style]


def _pad_to(ids, T: int) -> np.ndarray:
    out = np.zeros((T,), np.int32)
    out[: min(len(ids), T)] = ids[:T]
    return out


def _nll(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.log(probs[torch.arange(len(labels)), labels] + 1e-9))


def classifier_step(state, tx, loss_fn):
    """One optimizer step on ``loss_fn(params)`` -> (new state, loss)."""
    loss, grads = _value_and_grad(loss_fn, state.params)
    return state.apply_gradients(grads, tx), loss


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--kind", type=str, default="small",
                        choices=["style3", "style4", "domain", "small", "essence"])
    parser.add_argument("--bert-hidden", type=int, default=768)
    parser.add_argument("--bert-layers", type=int, default=12)
    parser.add_argument("--bert-weights", type=str, default="",
                        help="a HuggingFace BertModel state dict (.pt) for the trunk")
    parser.add_argument("--save", type=str, default="",
                        help="pickle the trained classifier params here "
                             "(read by train_hypernet --style-classifier)")
    parser.add_argument("--warm-start", type=str, default="",
                        help="pickle of a previously trained BERT-family classifier "
                             "(same --bert-hidden/--bert-layers); its 'bert' trunk "
                             "initializes this one")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    V = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    generator = torch.Generator().manual_seed(train_cfg.seed)

    # 90/10 held-out split (by image for styles, by row for domains)
    if args.kind == "domain":
        rows = load_cc_captions(data_cfg.cc_captions)
        domains = sorted({d for _, _, d in rows})
        dom_id = {d: i for i, d in enumerate(domains)}
        num_class = len(domains)
        all_ex = [(np.array(vocab.encode(cap)[: train_cfg.max_len]), dom_id[d])
                  for _, cap, d in rows]
        rs = np.random.RandomState(train_cfg.seed)
        perm = rs.permutation(len(all_ex))
        cut = max(1, len(all_ex) // 10)
        examples = [all_ex[i] for i in perm[cut:]]
        heldout = [all_ex[i] for i in perm[:cut]]
    else:
        num_class = {"style3": 3, "style4": 4, "small": 3}.get(args.kind, 2)
        rng = random.Random(train_cfg.seed)
        rs = np.random.RandomState(train_cfg.seed)
        perm = rs.permutation(len(data))
        cut = max(1, len(data) // 10)
        examples = list(_style_examples(data, perm[cut:], rng))
        heldout = list(_style_examples(data, perm[:cut], rng))
        if args.kind == "style4":
            # the fourth class: Conceptual Captions text, label 3
            if not os.path.exists(data_cfg.cc_captions):
                raise SystemExit("--kind style4 needs --cc-captions (the CC class)")
            cc_ex = [(np.array(vocab.encode(cap)[: train_cfg.max_len]), 3)
                     for _, cap, _ in load_cc_captions(data_cfg.cc_captions)]
            ccut = max(1, len(cc_ex) // 10)
            cperm = rs.permutation(len(cc_ex))
            examples += [cc_ex[i] for i in cperm[ccut:]]
            heldout += [cc_ex[i] for i in cperm[:ccut]]
    print(f"kind={args.kind} classes={num_class} examples={len(examples)} "
          f"heldout={len(heldout)}")

    if args.kind == "small":
        params = small_style_classifier_init(generator, V, model_cfg.embed_size, num_class,
                                             device=device)
        apply_fn = lambda p, ids, mask: small_style_classifier_apply(p, ids)  # noqa: E731
    elif args.kind == "essence":
        params = essence_classifier_init(generator, V, args.bert_hidden, args.bert_layers,
                                         device=device)
        apply_fn = None
    else:
        params = style_classifier_init(generator, V, num_class, args.bert_hidden,
                                       args.bert_layers, device=device)
        if args.bert_weights:
            params["bert"] = bert_trunk_from_hf_state_dict(
                torch.load(args.bert_weights, map_location="cpu"),
                args.bert_hidden, args.bert_layers, device=device)
        apply_fn = style_classifier_apply
    if args.warm_start and args.kind != "small":
        with open(args.warm_start, "rb") as f:
            donor = pickle.load(f)
        if "bert" not in donor:
            raise SystemExit("--warm-start pickle has no 'bert' trunk")
        shape = lambda x: tuple(x.shape)  # noqa: E731
        if tree_map(shape, donor["bert"]) != tree_map(shape, params["bert"]):
            raise SystemExit(
                f"--warm-start trunk dims mismatch: {args.warm_start} vs "
                f"--bert-hidden {args.bert_hidden} --bert-layers {args.bert_layers}")
        params["bert"] = from_jax_params(donor["bert"], device)
        print(f"warm-started {args.kind} trunk from {args.warm_start}")

    tx = make_optimizer(train_cfg.lr, train_cfg.grad_clip)
    state = create_train_state(params, tx, device=device)
    logger = MetricLogger(train_cfg.checkpoint_dir, args.run_name)
    T = train_cfg.max_len
    on_device = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    mask_of = lambda ids: (ids != 0).float()  # noqa: E731

    if args.kind == "essence":
        # pairs: the same image across styles (label 1) or another (label 0);
        # held-out images never appear in training pairs
        rng = random.Random(0)
        train_imgs = [int(i) for i in perm[cut:]]
        held_imgs = [int(i) for i in perm[:cut]]

        def make_pairs(imgs, prng):
            a, b, y = [], [], []
            for i in imgs:
                same = prng.random() < 0.5
                j = i if same else prng.choice(imgs)
                a.append(_pad_to(data.caption_ids("factual", i, rng=prng), T))
                b.append(_pad_to(data.caption_ids("humour", j, rng=prng), T))
                y.append(1 if (same or j == i) else 0)
            return np.stack(a), np.stack(b), np.array(y, np.int32)

        def pair_batches():
            idx = list(train_imgs)
            rng.shuffle(idx)
            for s in range(0, len(idx) - train_cfg.batch_size, train_cfg.batch_size):
                chunk = idx[s : s + train_cfg.batch_size]
                a, b, y = [], [], []
                for i in chunk:
                    same = rng.random() < 0.5
                    j = i if same else rng.choice(idx)
                    a.append(_pad_to(data.caption_ids("factual", i, rng=rng), T))
                    b.append(_pad_to(data.caption_ids("humour", j, rng=rng), T))
                    y.append(1 if same else 0)
                yield np.stack(a), np.stack(b), np.array(y, np.int32)

        def pair_step(state, a, b, y):
            a, b, y = on_device(a), on_device(b), on_device(y).long()
            return classifier_step(state, tx, lambda p: _nll(essence_classifier_apply(
                p, a, mask_of(a), b, mask_of(b)), y))

        gstep = 0
        for epoch in range(train_cfg.max_epochs):
            for a, b, y in pair_batches():
                state, loss = pair_step(state, a, b, y)
                gstep += 1
                if gstep % train_cfg.log_every == 0:
                    logger.log({"train_loss": float(loss)}, gstep)
            print(f"epoch {epoch} loss {float(loss):.4f}")
        ha, hb, hy = make_pairs(held_imgs, random.Random(train_cfg.seed + 7))
        with torch.no_grad():
            ta, tb = on_device(ha), on_device(hb)
            hp = essence_classifier_apply(state.params, ta, mask_of(ta), tb,
                                          mask_of(tb)).cpu().numpy()
        hacc = float((hp.argmax(-1) == hy).mean())
        logger.log({"heldout_acc": hacc})
        print(f"heldout pair accuracy: {hacc:.4f} ({len(hy)} pairs)")
        _maybe_save(args.save, state.params)
        return state, hacc

    rng = random.Random(1)

    def batches():
        ex = list(examples)
        rng.shuffle(ex)
        for s in range(0, len(ex) - train_cfg.batch_size, train_cfg.batch_size):
            chunk = ex[s : s + train_cfg.batch_size]
            ids = np.stack([_pad_to(np.asarray(c[0]), T) for c in chunk])
            labels = np.array([c[1] for c in chunk], np.int32)
            yield ids, labels

    gstep = 0
    for epoch in range(train_cfg.max_epochs):
        correct = total = 0
        for ids, labels in batches():
            tids, tlabels = on_device(ids), on_device(labels).long()
            state, loss = classifier_step(
                state, tx, lambda p: _nll(apply_fn(p, tids, mask_of(tids)), tlabels))
            gstep += 1
            if gstep % train_cfg.log_every == 0:
                with torch.no_grad():
                    probs = apply_fn(state.params, tids, mask_of(tids))
                correct += int((probs.argmax(-1).cpu().numpy() == labels).sum())
                total += len(labels)
                logger.log({"train_loss": float(loss)}, gstep)
        acc = correct / max(total, 1)
        print(f"epoch {epoch} loss {float(loss):.4f} sampled-acc {acc:.3f}")

    # held-out accuracy, in padded batches of the training shape
    Bs = train_cfg.batch_size
    correct = total = 0
    with torch.no_grad():
        for s in range(0, len(heldout), Bs):
            chunk = heldout[s : s + Bs]
            ids = np.zeros((Bs, T), np.int32)
            for i, c in enumerate(chunk):
                ids[i] = _pad_to(np.asarray(c[0]), T)
            labels = np.array([c[1] for c in chunk], np.int32)
            tids = on_device(ids)
            probs = apply_fn(state.params, tids, mask_of(tids)).cpu().numpy()[: len(chunk)]
            correct += int((probs.argmax(-1) == labels).sum())
            total += len(labels)
    hacc = correct / max(total, 1)
    logger.log({"heldout_acc": hacc})
    print(f"heldout accuracy: {hacc:.4f} ({total} examples, "
          f"chance {1.0 / num_class:.3f})")
    _maybe_save(args.save, state.params)
    return state, hacc


def _maybe_save(path: str, params) -> None:
    """The params as a pickle of numpy arrays (captionax's format)."""
    if not path:
        return
    with open(path, "wb") as f:
        pickle.dump(to_numpy_tree(params), f)
    print(f"saved classifier params -> {path}")


if __name__ == "__main__":
    main()
