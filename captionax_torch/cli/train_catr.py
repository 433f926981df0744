"""Train the CATR (DETR-style encoder-decoder) transformer baseline.

Port of ``captionax/cli/train_catr.py``: causal teacher-forced CE over
FlickrStyle captions with the CATR hyperparameters (hidden 256, 8 heads,
FFN 2048, 6 + 6 layers), then a greedy decode of the validation split
with its metrics.  The frozen ResNet's bottleneck chains run on K4.  Runs
on the card unless ``--device cpu`` is given.

captionax's choices kept: the FFN width is 2048 whatever ``--hidden``;
the epoch line prints the last step's loss, which raises when an epoch
had no train batch.

``--pipe N`` runs both halves of the train step's transformer as N-stage
pipelines (``parallel/pipeline.py``'s ``pipelined_catr_stacks``,
``--pipe-micro`` microbatches, default 2N) over N slots of ``--device`` (a
one-card machine repeats its card), the flags checked as captionax checks
them; the greedy decode stays sequential.

``--mesh-data`` is accepted and ignored: this CLI runs on one mesh of one
process, as captionax's does.

    python -m captionax_torch.cli.train_catr --synthetic --max-epochs 2 \\
        --enc-layers 2 --dec-layers 2 --device cpu
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
from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.data.loader import BatchLoader
from captionax_torch.eval.metrics import CaptionMetrics
from captionax_torch.models.catr import catr_forward, catr_greedy, catr_init
from captionax_torch.train.logging import MetricLogger
from captionax_torch.train.losses import cross_entropy_loss
from captionax_torch.train.state import create_train_state, get_lr, make_optimizer
from captionax_torch.train.steps import _value_and_grad

FF = 2048


def build_catr_model(generator: torch.Generator, V: int, hidden: int, heads: int,
                     enc_layers: int, dec_layers: int, device: DeviceLike = None):
    """CATR over ``V`` ids, FFN 2048."""
    return catr_init(generator, V, hidden=hidden, num_heads=heads, ff=FF,
                     enc_layers=enc_layers, dec_layers=dec_layers, device=device)


def make_train_step(tx, num_heads: int, stacks=(None, None)):
    """``train_step(state, feats, captions) -> (state, loss)``: captions[:, :-1]
    predict captions[:, 1:]; ``stacks`` = (encoder_fn, decoder_fn) replace
    the sequential stacks (``--pipe``)."""
    encoder_fn, decoder_fn = stacks

    def train_step(state, feats, captions):
        def loss_fn(p):
            logits = catr_forward(p, feats, captions[:, :-1], encoder_fn=encoder_fn,
                                  decoder_fn=decoder_fn, num_heads=num_heads)
            return cross_entropy_loss(logits, captions[:, 1:])

        loss, grads = _value_and_grad(loss_fn, state.params)
        return state.apply_gradients(grads, tx), loss

    return train_step


def pipelined_stacks(parser, args, batch_size: int):
    """``--pipe``'s (encoder_fn, decoder_fn), (None, None) without it, after
    captionax's checks of the flags."""
    if args.pipe <= 1:
        return None, None
    from captionax_torch.parallel.mesh import default_devices
    from captionax_torch.parallel.pipeline import pipeline_mesh, pipelined_catr_stacks

    n_micro = args.pipe_micro or 2 * args.pipe
    for name, n in (("--enc-layers", args.enc_layers), ("--dec-layers", args.dec_layers)):
        if n % args.pipe:
            parser.error(f"{name} {n} must divide by --pipe {args.pipe}")
    if batch_size % n_micro:
        parser.error(f"--batch-size {batch_size} must divide by --pipe-micro {n_micro}")
    return pipelined_catr_stacks(
        pipeline_mesh(n_pipe=args.pipe, devices=default_devices(args.pipe, args.device)),
        n_micro=n_micro, num_heads=args.heads)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--enc-layers", type=int, default=6)
    parser.add_argument("--dec-layers", type=int, default=6)
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--pipe", type=int, default=1,
                        help="pipeline-parallel stages for both transformer halves (train "
                             "step only; enc/dec layer counts divisible by it)")
    parser.add_argument("--pipe-micro", type=int, default=0,
                        help="microbatches per step (default 2*pipe; batch size must "
                             "divide by it)")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    device = resolve_device(args.device)
    stacks = pipelined_stacks(parser, args, train_cfg.batch_size)

    vocab = resolve_vocab(data_cfg)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    print(f"vocab={len(vocab)} images={len(data)}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_catr_model(g_model, len(vocab), args.hidden, args.heads, args.enc_layers,
                              args.dec_layers, device)
    encode = make_encoder(build_encoder(model_cfg, g_encoder, args.encoder_weights, device),
                          device=device)
    featurize = make_feature_fn(encode, train_cfg, device)
    tx = make_optimizer(train_cfg.lr, train_cfg.grad_clip, donate=True)
    state = create_train_state(params, tx, device=device)
    del params
    logger = MetricLogger(train_cfg.checkpoint_dir, args.run_name)
    train_step = make_train_step(tx, args.heads, stacks)

    train_idx, val_idx, _ = data.splits(seed=train_cfg.seed)
    step = 0
    for epoch in range(train_cfg.max_epochs):
        for batch in BatchLoader(
            data.batches(train_idx, train_cfg.batch_size, style="factual",
                         seed=train_cfg.seed + epoch), device=device,
        ):
            state, loss = train_step(state, featurize(batch), batch["captions"].long())
            step += 1
            if step % train_cfg.log_every == 0:
                logger.log({"train_loss": float(loss), "epoch": epoch}, step)
        print(f"epoch {epoch} train_loss {float(loss):.4f} lr {get_lr(state):.2e}")

    quality = CaptionMetrics(vocab)
    n_val = 0
    for sample in BatchLoader(
        data.batches(val_idx, train_cfg.batch_size, style="factual",
                     seed=0, shuffle=False, drop_remainder=False), device=device,
    ):
        ids = catr_greedy(state.params, featurize(sample), max_len=train_cfg.max_len,
                          num_heads=args.heads)
        quality.add_batch_ids(sample["captions"], ids)
        n_val += len(ids)
    if n_val == 0:  # empty validation split at tiny dataset sizes
        print("no validation batches; skipping greedy smoke")
        return state
    metrics = {k: round(v, 4) for k, v in quality.compute().items()}
    logger.log({f"val_greedy_{k}": v for k, v in metrics.items()}, step)
    print(f"greedy metrics ({n_val} val images):", metrics)
    return state


if __name__ == "__main__":
    main()
