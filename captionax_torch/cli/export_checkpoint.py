"""Export a checkpoint of the port to the reference's Lightning layout.

Port of ``captionax/cli/export_checkpoint.py``, the inverse of
``import_checkpoint``: reads a checkpoint written by the port's trainers
(``train_gru``, ``train_hypernet``, ``cc_train_hypernet``; the port's
format, ``train/checkpoint.py``) and writes, with ``torch.save``, a
``.ckpt`` whose ``state_dict`` loads into the reference modules
(``CaptionAttentionGru``, ``HyperNet``, ``HyperNetCC``): strict on the
exported submodules, and with ``--encoder-weights`` (a torchvision-named
ResNet, e.g. from ``import_checkpoint --encoder-out``) the frozen
``image_encoder`` too.  Importing the file back reproduces the params bit
for bit.

    python -m captionax_torch.cli.export_checkpoint --checkpoint-dir ckpts/run \\
        --kind hypernet --out hypernet.ckpt [--encoder-weights resnet.pt]
"""

from __future__ import annotations

import argparse
import json

import torch

from captionax_torch.models.convert import export_lightning_state_dict, trunk_to_lightning
from captionax_torch.train.checkpoint import restore_checkpoint


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True, help="the port's checkpoint directory")
    p.add_argument("--kind", required=True, choices=["gru", "hypernet", "hypernet_cc"])
    p.add_argument("--out", required=True, help="Lightning-layout .ckpt to write")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: the latest)")
    p.add_argument("--encoder-weights", default="",
                   help="torchvision-named ResNet .pt (e.g. from import_checkpoint "
                        "--encoder-out) to embed as the frozen image_encoder")
    p.add_argument("--hparams", default="", help="JSON dict recorded as hyper_parameters")
    args = p.parse_args(argv)

    params = restore_checkpoint(args.checkpoint_dir, step=args.step)
    sd = export_lightning_state_dict(args.kind, params)
    if args.encoder_weights:
        trunk = torch.load(args.encoder_weights, map_location="cpu", weights_only=True)
        sd.update(trunk_to_lightning(trunk, args.kind))
    blob = {"state_dict": sd,
            "hyper_parameters": json.loads(args.hparams) if args.hparams else {}}
    torch.save(blob, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"exported {args.kind}: {len(sd)} tensors / {n:,} parameters -> {args.out}")
    print("reimport check: python -m captionax_torch.cli.import_checkpoint "
          f"--ckpt {args.out} --out <dir>")
    return blob


if __name__ == "__main__":
    main()
