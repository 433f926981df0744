"""Train the LSTM captioner family.

Port of ``captionax/cli/train_lstm.py``, one CLI for the reference's four
LSTM scripts:
- ``--variant seq``: the ResNet's global feature through a trainable
  projection, then the plain seq2seq LSTM (``DecoderLstm``);
- ``--variant attention``: the attention LSTM over the raw region
  features;
- ``--variant sat``: the Show-Attend-Tell decoder with its gated attention;
- ``--variant net``: ``Lstm_net``, the feature as the first LSTM token (the
  ``seq`` model).

After training, a held-out validation: the teacher-forced loss and
metrics for every variant, plus the greedy decode's metrics for
``attention`` and ``sat``; then the final checkpoint in the port's format
(``<checkpoint-dir>/<step>/tree.pt``).  The frozen ResNet's chains run on
K4; ``--cache-features`` / ``--cache-features-device`` encode each image
once.  Runs on the card unless ``--device cpu`` is given.

``--mesh-data`` is accepted and ignored: this CLI runs on one device,
as captionax's does.

    python -m captionax_torch.cli.train_lstm --variant attention --synthetic --device cpu
"""

from __future__ import annotations

import torch

from captionax_torch.cli.common import (
    build_encoder,
    make_encoder,
    make_feature_fn,
    make_parser,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_vocab,
)
from captionax_torch.core.runtime import resolve_device
from captionax_torch.data.loader import BatchLoader
from captionax_torch.eval.metrics import CaptionMetrics
from captionax_torch.models.cell_decoders import (
    show_attend_tell_forward,
    show_attend_tell_init,
    show_attend_tell_sample,
)
from captionax_torch.models.decoder import (
    attention_lstm_init,
    lstm_greedy,
    lstm_teacher_forced,
    seq_lstm_forward,
    seq_lstm_init,
)
from captionax_torch.train.checkpoint import save_checkpoint
from captionax_torch.train.logging import MetricLogger
from captionax_torch.train.losses import cross_entropy_loss
from captionax_torch.train.state import create_train_state, get_lr, make_optimizer
from captionax_torch.train.steps import _value_and_grad

VARIANTS = ("seq", "attention", "sat", "net")


def build_lstm_model(variant: str, generator: torch.Generator, E: int, H: int, V: int,
                     device=None):
    """-> (params, forward): ``forward(params, batch) -> (logits,
    targets)``; whether it needs region or global features follows from
    :func:`uses_regions`."""
    dev = resolve_device(device)
    if variant in ("seq", "net"):
        proj_w = torch.randn((2048, E), generator=generator) * 0.02
        params = {"proj": {"w": proj_w.to(dev), "b": torch.zeros((E,), device=dev)},
                  "dec": seq_lstm_init(generator, E, H, V, device=dev)}

        def forward(params, batch):
            feat = batch["features"] @ params["proj"]["w"] + params["proj"]["b"]
            return seq_lstm_forward(params["dec"], feat, batch["captions"]), batch["captions"]
    elif variant == "attention":
        params = attention_lstm_init(generator, 2048, E, H, V, device=dev)

        def forward(params, batch):
            logits, _ = lstm_teacher_forced(params, batch["features"], batch["captions"])
            return logits, batch["captions"]
    else:  # sat
        params = show_attend_tell_init(generator, 2048, E, H, H, V, device=dev)

        def forward(params, batch):
            logits, _ = show_attend_tell_forward(params, batch["features"], batch["captions"])
            return logits, batch["captions"][:, 1:]  # predicts the next token
    return params, forward


def uses_regions(variant: str) -> bool:
    return variant in ("attention", "sat")


def make_train_step(forward, tx):
    """``train_step(state, batch) -> (state, loss)``: the masked CE of the
    variant's logits."""
    def train_step(state, batch):
        def loss_fn(p):
            logits, targets = forward(p, batch)
            return cross_entropy_loss(logits, targets)

        loss, grads = _value_and_grad(loss_fn, state.params)
        return state.apply_gradients(grads, tx), loss

    return train_step


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--variant", type=str, default="attention", choices=VARIANTS)
    parser.add_argument("--encoder-weights", type=str, default="")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    V = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    print(f"variant={args.variant} vocab={V} images={len(data)}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    E, H = model_cfg.embed_size, model_cfg.hidden_size
    encoder_params = build_encoder(model_cfg, g_encoder, args.encoder_weights, device)
    params, forward = build_lstm_model(args.variant, g_model, E, H, V, device)
    encode = make_encoder(encoder_params, regions=uses_regions(args.variant), device=device)

    featurize = make_feature_fn(encode, train_cfg, device)
    tx = make_optimizer(train_cfg.lr, train_cfg.grad_clip, donate=True)
    state = create_train_state(params, tx, device=device)
    logger = MetricLogger(train_cfg.checkpoint_dir, args.run_name)
    train_step = make_train_step(forward, tx)

    def device_batch(batch):
        return {"features": featurize(batch), "captions": batch["captions"].long()}

    train_idx, val_idx, _ = data.splits(seed=train_cfg.seed)
    step = 0
    loss = torch.tensor(float("nan"))
    for epoch in range(train_cfg.max_epochs):
        for batch in BatchLoader(
            data.batches(train_idx, train_cfg.batch_size, style="factual",
                         seed=train_cfg.seed + epoch), device=device,
        ):
            state, loss = train_step(state, device_batch(batch))
            step += 1
            if step % train_cfg.log_every == 0:
                logger.log({"train_loss": float(loss), "epoch": epoch}, step)
        print(f"epoch {epoch} loss {float(loss):.4f} lr {get_lr(state):.2e}")

    # held-out validation: the teacher-forced loss and metrics for every
    # variant, and the greedy decode's metrics where the variant has one
    tf_quality = CaptionMetrics(vocab)
    greedy_quality = CaptionMetrics(vocab) if uses_regions(args.variant) else None
    val_losses = []
    with torch.no_grad():
        for batch in BatchLoader(
            data.batches(val_idx, train_cfg.batch_size, style="factual",
                         seed=0, shuffle=False, drop_remainder=False), device=device,
        ):
            db = device_batch(batch)
            logits, targets = forward(state.params, db)
            val_losses.append(float(cross_entropy_loss(logits, targets)))
            tf_quality.add_batch_logits(targets.cpu().numpy(), logits.cpu().numpy())
            if args.variant == "attention":
                ids = lstm_greedy(state.params, db["features"], max_len=train_cfg.max_len)
            elif args.variant == "sat":
                ids = show_attend_tell_sample(state.params, db["features"],
                                              max_len=train_cfg.max_len)
            if greedy_quality is not None:
                greedy_quality.add_batch_ids(db["captions"].cpu().numpy(), ids.cpu().numpy())
    results = {}
    if val_losses:
        results["val_loss_tf"] = sum(val_losses) / len(val_losses)
        results.update({f"tf_{k}": v for k, v in tf_quality.compute().items()})
        if greedy_quality is not None:
            results.update({f"greedy_{k}": v for k, v in greedy_quality.compute().items()})
        logger.log(results, step)
        print("val:", {k: round(v, 4) for k, v in results.items()})
    save_checkpoint(train_cfg.checkpoint_dir, step, state.params)
    return state, results


if __name__ == "__main__":
    main()
