"""Hypernet distillation init: pretrain the hypernet to regress the GRU
weights of per-style captioners before end-to-end training.

Port of ``captionax/cli/train_init.py`` (the reference's train_init.py):
cycle the three styles, take the MSE between the hypernet's flat theta for
a style's token row and that style's GRU weights (from
``--style-checkpoints``, port checkpoints of ``cli/train_gru``, or drawn
from seeds 0-2), with plain Adam (optax's defaults: b1 0.9, b2 0.999,
eps 1e-8; no clip, no skip), until ``--loss-threshold`` or
``--max-steps``; then save the model as step 0 of ``--checkpoint-dir`` in
the port's format, which ``train_hypernet --init-hn`` and
``train_hyper_combine --init-hn`` read.  Runs on the card unless
``--device cpu`` is given.

    python -m captionax_torch.cli.train_init --synthetic --max-steps 200
"""

from __future__ import annotations

import torch

from captionax_torch.cli.common import (
    build_captioner,
    build_hypernet_model,
    make_parser,
    model_generators,
    parse_configs,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.models.hypernet import hypernet_apply_flat
from captionax_torch.models.layers import embedding
from captionax_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from captionax_torch.train.state import create_train_state, make_optimizer
from captionax_torch.train.steps import _value_and_grad


def flat_gru(params) -> torch.Tensor:
    g = params["gru"]
    return torch.cat([g[k].reshape(-1) for k in ("w_ih", "w_hh", "b_ih", "b_hh")])


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=2000)
    parser.add_argument("--loss-threshold", type=float, default=1e-9)
    parser.add_argument("--style-checkpoints", type=str, default="",
                        help="comma-separated per-style captioner checkpoint dirs "
                             "(factual,humour,romantic); random targets if empty")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    model_cfg.vocab_size = len(vocab)
    g_model, _ = model_generators(train_cfg.seed)
    params = build_hypernet_model(model_cfg, vocab, g_model, device=device)

    styles = ["factual", "humour", "romantic"]
    style_ids = [torch.tensor(vocab(s), device=device) for s in styles]
    if args.style_checkpoints:
        like = build_captioner(model_cfg, vocab, model_generators(train_cfg.seed)[0], device)
        targets = [flat_gru(restore_checkpoint(d, like=like))
                   for d in args.style_checkpoints.split(",")]
    else:
        targets = [flat_gru(build_captioner(model_cfg, vocab, torch.Generator().manual_seed(i),
                                            device))
                   for i in range(3)]

    # optax.adam(lr): no clip (an infinite norm bound), no non-finite skip
    tx = make_optimizer(train_cfg.lr, clip_norm=float("inf"), skip_nonfinite=False)
    state = create_train_state(params["hn"], tx, device=device)
    embed_table = params["decoder"]["embed"]
    loss = torch.tensor(float("nan"))
    for i in range(args.max_steps):
        e = embedding(embed_table, style_ids[i % 3])
        loss, grads = _value_and_grad(
            lambda hn: torch.mean((hypernet_apply_flat(hn, e) - targets[i % 3]) ** 2),
            state.params)
        state = state.apply_gradients(grads, tx)
        if i % 100 == 0:
            print(f"step {i} style {styles[i % 3]} mse {float(loss):.3e}")
        if float(loss) < args.loss_threshold:
            break
    params["hn"] = state.params
    save_checkpoint(train_cfg.checkpoint_dir, 0, params)
    print(f"distilled hypernet saved to {train_cfg.checkpoint_dir}, "
          f"final mse {float(loss):.3e}")
    return params


if __name__ == "__main__":
    main()
