"""Import a trained reference Lightning checkpoint into the port.

Port of ``captionax/cli/import_checkpoint.py``.  Converts a ``.ckpt`` saved
by the reference trainers (``CaptionAttentionGru``, ``HyperNet`` or
``HyperNetCC``; ``models/convert.py``) into the port's own checkpoint
format (``train/checkpoint.py``), which ``evaluate``, ``caption``,
``serve`` and the trainers restore, and with ``--encoder-out`` writes the
checkpoint's frozen ResNet trunk as a torchvision-named state_dict for
``--encoder-weights``.  The conversion runs on ``--device`` (the card
unless ``--device cpu``); the checkpoint holds CPU tensors either way.

    python -m captionax_torch.cli.import_checkpoint --ckpt epoch=19.ckpt \\
        --out ckpts/imported --encoder-out ckpts/imported_resnet.pt
    python -m captionax_torch.cli.evaluate --checkpoint-dir ckpts/imported \\
        --kind hypernet --encoder-weights ckpts/imported_resnet.pt ...
"""

from __future__ import annotations

import argparse

import torch

from captionax_torch.models.convert import load_lightning_checkpoint
from captionax_torch.models.layers import count_params
from captionax_torch.train.checkpoint import save_checkpoint
from captionax_torch.train.state import tree_leaves


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="reference Lightning .ckpt (or a torch.save of a bare state_dict)")
    p.add_argument("--out", required=True, help="checkpoint directory to write")
    p.add_argument("--encoder-out", default="",
                   help="also save the checkpoint's frozen ResNet trunk as a "
                        "torchvision-named .pt for --encoder-weights")
    p.add_argument("--step", type=int, default=0, help="step number of the checkpoint")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to convert on (default: the card, 'cuda')")
    args = p.parse_args(argv)

    imported = load_lightning_checkpoint(args.ckpt, args.device)
    kind, params = imported["kind"], imported["params"]
    save_checkpoint(args.out, args.step, params)
    print(f"kind: {kind}")
    if imported["hparams"]:
        keep = {k: v for k, v in imported["hparams"].items()
                if isinstance(v, (int, float, str, bool))}
        print(f"hparams: {keep}")
    print(f"params: {len(tree_leaves(params))} tensors / {count_params(params):,} "
          f"parameters -> {args.out}")

    if args.encoder_out:
        if imported["encoder_state_dict"] is None:
            print("no image_encoder.* keys in the checkpoint; --encoder-out skipped")
        else:
            torch.save(imported["encoder_state_dict"], args.encoder_out)
            print(f"encoder trunk -> {args.encoder_out} (use --encoder-weights)")

    eval_kind = "gru" if kind == "gru" else "hypernet"
    print(f"evaluate with: python -m captionax_torch.cli.evaluate --checkpoint-dir {args.out} "
          f"--kind {eval_kind}"
          + (f" --encoder-weights {args.encoder_out}" if args.encoder_out else ""))
    return imported


if __name__ == "__main__":
    main()
