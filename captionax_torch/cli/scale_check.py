"""Check a multi-device sharding configuration before spending card time.

Port of ``captionax/cli/scale_check.py``, with its flags, defaults and
printed lines.  One process drives every slot of the mesh:

- ``--kind gru`` / ``hypernet``: a ``data x model`` mesh; the decoder's fc
  ``w`` split by columns and ``b`` with it (:func:`vocab_tp_sharding`),
  ``embed`` by rows, and with ``hypernet`` each hypernet head's ``l1``
  by columns, as captionax places them; ``--steps`` train steps on the
  plain recurrence (``make_*_steps(tx)``, no ``--fused-scan``, as
  captionax), data shard r on row r (``train.steps.mesh_train_step``); a
  finite loss, and the first step's loss and gradients against the same
  step unsharded on one device;
- ``--kind labert``: with ``--pipe`` (or ``--seq [--seq-ring]``) a
  pipelined (or sequence-split) LaBERT loss and gradients on a ``data x
  pipe`` (``data x seq``) mesh, the loss within 1e-3 of the sequential
  stack's.

``--virtual N`` runs on N slots on the CPU.  Without it the slots are the
cards (``default_devices``): a one-card machine repeats its card in every
slot, where captionax would ask for as many chips.

    python -m captionax_torch.cli.scale_check --virtual 8 --mesh-data 4 \\
        --mesh-model 2 --kind hypernet
    python -m captionax_torch.cli.scale_check --virtual 8 --pipe 4 --kind labert
"""

from __future__ import annotations

import argparse
import sys

import torch

SEQ_TOL = 1e-3    # the pipelined / sequence-split LaBERT loss against the sequential stack's
STEP_RTOL = 1e-5  # the sharded step's first loss and gradients against the unsharded step's


def parse(argv):
    parser = argparse.ArgumentParser(prog="scale_check", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--virtual", type=int, default=0,
                        help="use N slots on the CPU instead of the cards")
    parser.add_argument("--kind", default="hypernet", choices=["gru", "hypernet", "labert"])
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-axis size (default: devices / model)")
    parser.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel axis size")
    parser.add_argument("--pipe", type=int, default=0,
                        help="pipeline stages (labert only; uses a data x pipe mesh instead "
                             "of data x model)")
    parser.add_argument("--seq", type=int, default=0,
                        help="sequence-parallel shards of the token axis (labert only; data "
                             "x seq mesh)")
    parser.add_argument("--seq-ring", action="store_true",
                        help="with --seq: ring-attention schedule")
    parser.add_argument("--feature-size", type=int, default=200)
    parser.add_argument("--embed-size", type=int, default=200)
    parser.add_argument("--hidden-size", type=int, default=200)
    parser.add_argument("--vocab-size", type=int, default=9684)
    parser.add_argument("--num-features", type=int, default=2048)
    parser.add_argument("--hidden", type=int, default=768, help="labert hidden size")
    parser.add_argument("--bert-layers", type=int, default=12)
    parser.add_argument("--bert-heads", type=int, default=12)
    parser.add_argument("--steps", type=int, default=2)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(list(sys.argv[1:] if argv is None else argv))
    if args.virtual:
        n_devices, kind = args.virtual, "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --virtual N for N slots "
                               "on the CPU")
        n_devices, kind = torch.cuda.device_count(), "cuda"
    print(f"devices: {n_devices} x {kind}")
    if args.kind == "labert":
        return _check_labert(args, n_devices)
    return _check_captioner(args, n_devices)


def _slots(args, n: int) -> list:
    """n mesh slots: the CPU's under ``--virtual`` (at most N), else the cards
    (a card repeats where there are fewer)."""
    from captionax_torch.parallel.mesh import default_devices

    if args.virtual and n > args.virtual:
        raise SystemExit(f"a mesh of {n} needs {n} devices, have {args.virtual}")
    return default_devices(n, "cpu" if args.virtual else None)


def grad_share(got, ref) -> float:
    """The largest over the leaves of max |got - ref| over the leaf's
    largest entry, or over 1e-3 where that is smaller (a leaf whose exact
    gradient is 0, as the attention's v_a bias under the softmax, holds
    float noise on both sides)."""
    from captionax_torch.train.state import tree_leaves

    return max((a.to(r.device) - r).abs().max().item() / max(r.abs().max().item(), 1e-3)
               for a, r in zip(tree_leaves(got), tree_leaves(ref)))


def place_model_axis(params, mesh):
    """A decoder tree (or ``{"decoder", "hn"}``) on data row 0 of ``mesh``
    with captionax's ``model``-axis placements: fc ``w`` and ``b`` split by
    columns, ``embed`` by rows, each hypernet head's ``l1`` by columns; the
    rest on the row's first slot.  A ``model`` axis of 1 places every leaf
    whole."""
    from captionax_torch.parallel.mesh import Sharding, place_on_row, vocab_tp_sharding

    cols, rows = vocab_tp_sharding(mesh), Sharding(mesh, 0)
    out = place_on_row(params, mesh, 0)
    dec_p = out["decoder"] if "hn" in out else out
    dec_p["fc"] = {k: cols.place(x) for k, x in dec_p["fc"].items()}
    dec_p["embed"] = rows.place(dec_p["embed"])
    for head in out.get("hn", {}).get("heads", {}).values():
        head["l1"] = {k: cols.place(x) for k, x in head["l1"].items()}
    return out


def _check_captioner(args, n_devices: int) -> dict:
    """gru / hypernet: the data x model training step."""
    from captionax_torch.interop import to_device
    from captionax_torch.models import decoder as dec
    from captionax_torch.models.hypernet import hypernet_init
    from captionax_torch.parallel.mesh import make_mesh, spec_of
    from captionax_torch.train.state import TrainState, make_optimizer, tree_map
    from captionax_torch.train.steps import (
        _value_and_grad,
        make_gru_steps,
        make_hypernet_steps,
        mesh_train_step,
    )

    n_model = args.mesh_model
    n_data = args.mesh_data or max(1, n_devices // n_model)
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=_slots(args, n_data * n_model))
    print(f"mesh: data{n_data} x model{n_model}")
    dev = mesh.data_devices[0]

    g = torch.Generator().manual_seed(0)
    nf, fo, e, h, v = (args.num_features, args.feature_size, args.embed_size,
                       args.hidden_size, args.vocab_size)
    decoder = dec.attention_gru_init(g, nf, fo, e, h, v, device=dev)
    # make_gru_steps trains the bare decoder tree; the hypernet step
    # trains {"decoder", "hn"}
    if args.kind == "hypernet":
        params = {"decoder": decoder,
                  "hn": hypernet_init(g, hyper_emb=e, input_dim=e + fo, hidden_dim=h, device=dev)}
    else:
        params = decoder
    plain = tree_map(lambda x: x.clone(), params)

    params = place_model_axis(params, mesh)

    B, R, T = 2 * n_data, 49, 12
    gb = torch.Generator().manual_seed(1)
    batch = {"features": torch.randn((B, R, nf), generator=gb),
             "captions": torch.randint(1, v, (B, T), generator=gb)}
    tx = make_optimizer(1e-3)
    if args.kind == "hypernet":
        batch["style_id"] = torch.tensor(0)
        step, _ = make_hypernet_steps(tx)
    else:
        step, _ = make_gru_steps(tx)
    batch = to_device(batch, dev)

    pstep = mesh_train_step(step.loss_fn, tx, mesh)
    # the first step's loss and gradients against the unsharded step's
    loss, grads = _value_and_grad(lambda p: pstep.loss_fn(p, batch), params)
    ref_loss, ref_grads = _value_and_grad(lambda p: step.loss_fn(p, batch), plain)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    share = grad_share(_joined(grads), ref_grads)
    print(f"first step == unsharded: loss {float(loss):.6f} / {float(ref_loss):.6f} "
          f"(relative {rel:.2e}), gradients within {share:.2e} of each leaf's largest entry "
          f"(at least 1e-3; bound {STEP_RTOL})")
    assert rel <= STEP_RTOL and share <= STEP_RTOL, (rel, share)

    state = TrainState(params, tx.init(params), torch.tensor(0, dtype=torch.int32, device=dev))
    losses = []
    for _ in range(args.steps):
        state, metrics = pstep(state, batch)
        losses.append(float(metrics["train_loss"]))
    assert all(x == x for x in losses), f"NaN loss: {losses}"
    fc_p = state.params["decoder"] if args.kind == "hypernet" else state.params
    print(f"train loss over {args.steps} steps: " + " -> ".join(f"{x:.4f}" for x in losses))
    print(f"fc sharding: {spec_of(fc_p['fc']['w'])}")
    print("scale_check OK")
    return {"mesh": mesh, "loss": float(loss), "ref_loss": float(ref_loss), "grads": grads,
            "ref_grads": ref_grads, "losses": losses, "grad_share": share}


def _joined(tree):
    """A tree with every split leaf joined into one tensor on its first
    part's device."""
    from captionax_torch.parallel.mesh import SHARDS

    if isinstance(tree, SHARDS):
        return torch.cat([p.to(tree[0].device) for p in tree], dim=type(tree).dim)
    if isinstance(tree, dict):
        return {k: _joined(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_joined(x) for x in tree)
    return tree


def _check_labert(args, n_devices: int) -> dict:
    """labert: the data x pipe pipelined (or data x seq sequence-split)
    loss and gradients against the sequential stack."""
    from captionax_torch.models import labert
    from captionax_torch.parallel.pipeline import pipeline_mesh, pipelined_bert_encoder
    from captionax_torch.train.state import tree_leaves
    from captionax_torch.train.steps import _value_and_grad

    n_pipe, n_seq = args.pipe or 1, args.seq or 1
    if n_pipe > 1 and n_seq > 1:
        raise SystemExit("--pipe and --seq are mutually exclusive")
    width = max(n_pipe, n_seq)
    if args.virtual and width > n_devices:
        raise SystemExit(f"--pipe/--seq {width} needs that many devices, have {n_devices}")
    n_data = args.mesh_data or max(1, n_devices // width)
    if n_pipe > 1 and args.bert_layers % n_pipe:
        raise SystemExit(f"--bert-layers {args.bert_layers} must divide by --pipe {n_pipe}")
    print(f"mesh: data{n_data} x " + (f"pipe{n_pipe}" if n_pipe > 1 else f"seq{n_seq}"))
    slots = _slots(args, n_data * width)
    dev = slots[0]

    params = labert.labert_init(torch.Generator().manual_seed(0), vocab_size=args.vocab_size,
                                hidden=args.hidden, num_layers=args.bert_layers,
                                num_heads=args.bert_heads, intermediate=4 * args.hidden,
                                num_regions=4, image_dim=args.num_features, device=dev)
    B, R, T = 2 * max(n_devices, n_data * width), 4, 6
    T += (-(R + T)) % n_seq  # 4 image + T text must divide by --seq
    g = torch.Generator().manual_seed(1)
    feats = torch.randn((B, R, args.num_features), generator=g).to(dev)
    ids = torch.randint(0, args.vocab_size, (B, T), generator=g).to(dev)
    types = torch.zeros((B, T), dtype=torch.int64, device=dev)
    draws = tuple(d.to(dev) for d in labert.mask_draws(torch.Generator().manual_seed(2), B, T,
                                                        device="cpu"))

    enc = None
    if n_pipe > 1:
        enc = pipelined_bert_encoder(pipeline_mesh(n_pipe, n_data, slots),
                                     n_micro=max(2, n_pipe), num_heads=args.bert_heads,
                                     data_axis="data")
    elif n_seq > 1:
        from captionax_torch.parallel.sequence import (
            sequence_mesh,
            sequence_parallel_bert_encoder,
        )

        enc = sequence_parallel_bert_encoder(sequence_mesh(n_seq, n_data, devices=slots),
                                             num_heads=args.bert_heads, data_axis="data",
                                             ring=args.seq_ring)

    def loss(p, encoder_fn=None):
        return labert.labert_loss(p, feats, ids, types, draws, mask_id=args.vocab_size - 1,
                                  num_heads=args.bert_heads, encoder_fn=encoder_fn)

    lp, grads = _value_and_grad(lambda p: loss(p, enc), params)
    assert float(lp) == float(lp), "NaN loss"
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(grads)), "non-finite grads"
    mode = "pipelined" if n_pipe > 1 else "seq-sharded" if n_seq > 1 else "sequential"
    msg = f"{mode} loss {float(lp):.4f}, grads finite"
    out = {"loss": float(lp), "grads": grads}
    if enc is not None:
        ls, ref_grads = _value_and_grad(loss, params)
        assert abs(float(lp) - float(ls)) < SEQ_TOL, (float(lp), float(ls))
        msg += f", == sequential {float(ls):.4f}"
        out.update(ref_loss=float(ls), ref_grads=ref_grads)
    print(msg)
    print("scale_check OK")
    return out


if __name__ == "__main__":
    main()
