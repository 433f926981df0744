"""HTML caption visualizer.

Port of ``captionax/cli/visualize.py``: decode test images per style and
write an HTML table of image / predicted caption / ground truth, assembled
directly (no ``dominate``), in the same bytes as captionax's.  The images
are encoded by the ResNet through ``make_encoder`` (bf16, its stride-1
bottleneck chains on K4 on the card) and decoded by the plain ``greedy``
(the argmax of ``log_softmax``, as captionax's CLI decodes).

- the default: a hypernet checkpoint, one column per style;
- ``--kind gru``: a bare captioner checkpoint (``train_gru``'s), one
  prediction per image, no style columns;
- ``--dataset cc``: a ``cc_train_hypernet`` checkpoint on the
  ``--cc-captions`` file, one row per domain (its first image), the theta
  from the domain embedder.

    python -m captionax_torch.cli.visualize --synthetic --out report.html

Runs on the card unless ``--device cpu`` is given.  The weights are drawn
from ``model_generators(--seed)``, as the training CLIs draw theirs, where
no checkpoint is found.
"""

from __future__ import annotations

import base64
import html
import io
import os

import numpy as np
import torch

from captionax_torch.cli.common import (
    build_captioner,
    build_encoder,
    build_hypernet_model,
    make_encoder,
    make_parser,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.decode.search import greedy
from captionax_torch.eval.metrics import ids_to_text
from captionax_torch.models.hypernet import hypernet_apply
from captionax_torch.train.checkpoint import restore_checkpoint
from captionax_torch.train.steps import resolve_style_id, synthesize_theta

STYLES = ("factual", "humour", "romantic")


def img_to_data_uri(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def render_rows(rows) -> str:
    cells = []
    for row in rows:
        tds = "".join(
            f"<td style='padding:6px;border:1px solid #ccc'>{c}</td>" for c in row
        )
        cells.append(f"<tr>{tds}</tr>")
    return (
        "<html><body><table style='border-collapse:collapse'>"
        + "".join(cells)
        + "</table></body></html>"
    )


def img_cell(img: np.ndarray) -> str:
    return f"<img src='{img_to_data_uri(img)}' width='160'>"


@torch.no_grad()
def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--out", type=str, default="report.html")
    parser.add_argument("--num-images", type=int, default=8)
    parser.add_argument("--dataset", type=str, default="flickr",
                        choices=["flickr", "cc"],
                        help="cc = visualize_gru_cc/visualize_hyper_cc: "
                             "caption CC images per domain")
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--kind", type=str, default="hypernet",
                        choices=["gru", "hypernet"],
                        help="gru = a plain captioner checkpoint "
                             "(visualize_gru): one prediction per image, "
                             "no style columns")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    g_model, g_encoder = model_generators(train_cfg.seed)
    if args.dataset == "cc":
        from captionax_torch.cli.cc_train_hypernet import build_cc_model_and_embedder
        from captionax_torch.data.cc import ConceptualCaptionsData, load_cc_captions
        from captionax_torch.data.synthetic import synthetic_image

        params, embedder, _ = build_cc_model_and_embedder(
            model_cfg, data_cfg, vocab, g_model, device=device)
        cc = ConceptualCaptionsData(
            load_cc_captions(data_cfg.cc_captions), vocab,
            image_loader=synthetic_image, max_len=train_cfg.max_len,
        )
    elif args.kind == "gru":
        # train_gru checkpoints the bare captioner tree
        params = build_captioner(model_cfg, vocab, g_model, device)
        data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    else:
        params = build_hypernet_model(model_cfg, vocab, g_model, device=device)
        data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    try:
        params = restore_checkpoint(train_cfg.checkpoint_dir, like=params)
        print(f"loaded checkpoint from {train_cfg.checkpoint_dir}")
    except FileNotFoundError:
        print("no checkpoint; visualizing the random-init model")
    if args.dataset != "cc" and args.kind == "gru":
        params = {"decoder": params}
    encode = make_encoder(build_encoder(model_cfg, g_encoder, args.encoder_weights, device),
                          device=device)

    def decode(feats: torch.Tensor, theta) -> np.ndarray:
        return greedy(params["decoder"], feats, max_len=train_cfg.max_len, gru_params=theta,
                      device=device).cpu().numpy()

    if args.dataset == "cc":
        # one row per (domain, image): predicted vs ground-truth caption
        rows = [["image", "<b>domain</b>", "predicted", "ground truth"]]
        shown = 0
        for dom in cc.domains:
            if shown >= args.num_images:
                break
            idx = cc.by_domain[dom][0]
            img = cc.image(idx)
            theta = hypernet_apply(
                params["hn"],
                embedder.embed(params["domain_emb"], np.asarray(embedder.host_vector(dom))),
            )
            toks = decode(encode(img[None]), theta)[0]
            rows.append([
                img_cell(img),
                html.escape(dom),
                html.escape(ids_to_text(toks, vocab)),
                html.escape(cc.rows[idx][1]),
            ])
            shown += 1
        with open(args.out, "w") as f:
            f.write(render_rows(rows))
        print(f"wrote {os.path.abspath(args.out)} ({shown} domains)")
        return args.out

    styles = ("factual",) if args.kind == "gru" else STYLES
    rows = [["image"] + [f"<b>{s}</b>" for s in styles] + ["ground truth"]]
    n = min(args.num_images, len(data))
    imgs = np.stack([data.image(i) for i in range(n)])
    feats = encode(imgs)
    per_style_tokens = {}
    for style in styles:
        theta = (None if args.kind == "gru"
                 else synthesize_theta(params, resolve_style_id(params, vocab, style)))
        per_style_tokens[style] = decode(feats, theta)
    for i in range(n):
        gt = ids_to_text(data.caption_ids("factual", i, pick=0), vocab)
        row = [img_cell(imgs[i])]
        for style in styles:
            row.append(html.escape(ids_to_text(per_style_tokens[style][i], vocab)))
        row.append(html.escape(gt))
        rows.append(row)

    with open(args.out, "w") as f:
        f.write(render_rows(rows))
    print(f"wrote {os.path.abspath(args.out)} ({n} images)")
    return args.out


if __name__ == "__main__":
    main()
