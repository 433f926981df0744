"""Train the LaBERT masked-LM transformer baseline.

Port of ``captionax/cli/train_labert.py``: masked-token prediction over
[image ‖ caption] with label smoothing 0.1, length-bucket token types,
plateau LR on the validation loss, then a mask-predict decode of up to 4
validation images at length 12.  A [MASK] token is appended to the vocab.
The frozen ResNet's bottleneck chains run on K4.  Runs on the card unless
``--device cpu`` is given.

Randomness.  Step ``s`` masks with the draws of :func:`step_mask_draws`
from a generator on the run's device seeded with ``s``, and every
validation batch with the draws of seed 0 (captionax draws them from
``PRNGKey(s)`` and ``PRNGKey(0)``).  ``--pipe``, ``--pipe-micro``,
``--seq`` and ``--seq-ring`` are read as captionax reads them; ``--pipe``
or ``--seq`` above 1 raises: pipeline and sequence parallelism are the ``ROADMAP.md`` queue
item "Parallelism" (6b).

``--mesh-data`` is accepted and ignored: this CLI runs on one device,
as captionax's does.

    python -m captionax_torch.cli.train_labert --synthetic --max-epochs 2 \\
        --hidden 128 --bert-layers 2 --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from captionax_torch.cli.common import (
    build_encoder,
    check_parallel_flags,
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
from captionax_torch.models.labert import (
    labert_init,
    labert_loss,
    length_bucket,
    mask_draws,
    mask_predict_decode,
)
from captionax_torch.train.logging import MetricLogger
from captionax_torch.train.state import (
    PlateauScheduler,
    create_train_state,
    get_lr,
    make_optimizer,
    set_lr,
)
from captionax_torch.train.steps import _value_and_grad

DEVICE_KEYS = ("images", "captions", "token_type_ids")


def add_type_ids(batches):
    """Each batch with ``token_type_ids`` [B, T]: its caption's length
    bucket + 2 on every position."""
    for b in batches:
        b = dict(b)
        lengths = b["lengths"]
        b["token_type_ids"] = np.asarray(
            [length_bucket(int(l)) + 2 for l in lengths], np.int32
        )[:, None].repeat(b["captions"].shape[1], 1)
        yield b


def build_labert_model(generator: torch.Generator, V: int, hidden: int, layers: int, heads: int,
                       device: DeviceLike = None):
    """LaBERT over ``V`` ids (the vocab and [MASK]), FFN 4 * hidden."""
    return labert_init(generator, V, hidden=hidden, num_layers=layers, num_heads=heads,
                       intermediate=hidden * 4, device=device)


def step_mask_draws(key: int, B: int, T: int, device: DeviceLike = None):
    """The mask draws (ratio [B, 1], scores [B, T]) of a generator on
    ``device`` seeded with ``key``: the step for a train step, 0 for
    validation."""
    dev = resolve_device(device)
    return mask_draws(torch.Generator(device=dev).manual_seed(key), B, T, device=dev)


def make_train_step(tx, mask_id: int, num_heads: int):
    """``train_step(state, feats, captions, types, draws) -> (state, loss)``."""
    def train_step(state, feats, captions, types, draws):
        loss, grads = _value_and_grad(
            lambda p: labert_loss(p, feats, captions, types, draws, mask_id,
                                  num_heads=num_heads), state.params)
        return state.apply_gradients(grads, tx), loss

    return train_step


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--hidden", type=int, default=768)
    parser.add_argument("--bert-layers", type=int, default=12)
    parser.add_argument("--bert-heads", type=int, default=12)
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--pipe", type=int, default=1,
                        help="pipeline-parallel stages for the BERT stack; not ported "
                             "yet, above 1 raises")
    parser.add_argument("--pipe-micro", type=int, default=0,
                        help="microbatches per step with --pipe")
    parser.add_argument("--seq", type=int, default=1,
                        help="sequence-parallel shards for the BERT token axis; not "
                             "ported yet, above 1 raises")
    parser.add_argument("--seq-ring", action="store_true",
                        help="with --seq: the ring-attention schedule")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    check_parallel_flags(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    mask_id = len(vocab)  # appended [MASK]
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    print(f"vocab={len(vocab)}+[MASK] images={len(data)}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_labert_model(g_model, len(vocab) + 1, args.hidden, args.bert_layers,
                                args.bert_heads, device)
    encode = make_encoder(build_encoder(model_cfg, g_encoder, args.encoder_weights, device),
                          device=device)
    featurize = make_feature_fn(encode, train_cfg, device)
    tx = make_optimizer(train_cfg.lr, train_cfg.grad_clip, donate=True)
    state = create_train_state(params, tx, device=device)
    del params
    logger = MetricLogger(train_cfg.checkpoint_dir, args.run_name)
    sched = PlateauScheduler(cooldown=train_cfg.plateau_cooldown,
                             factor=train_cfg.plateau_factor)
    train_step = make_train_step(tx, mask_id, args.bert_heads)

    def loader(indices, batch_size, **kw):
        return BatchLoader(add_type_ids(data.batches(indices, batch_size, style="factual", **kw)),
                           device=device, device_keys=DEVICE_KEYS)

    train_idx, val_idx, _ = data.splits(seed=train_cfg.seed)
    step = 0
    for epoch in range(train_cfg.max_epochs):
        for batch in loader(train_idx, train_cfg.batch_size, seed=train_cfg.seed + epoch):
            feats = featurize(batch)
            caps, types = batch["captions"].long(), batch["token_type_ids"].long()
            draws = step_mask_draws(step, *caps.shape, device)
            state, loss = train_step(state, feats, caps, types, draws)
            step += 1
            if step % train_cfg.log_every == 0:
                logger.log({"train_loss": float(loss), "epoch": epoch}, step)
        vals = []
        with torch.no_grad():
            for batch in loader(val_idx, train_cfg.batch_size, seed=0, shuffle=False,
                                drop_remainder=False):
                caps, types = batch["captions"].long(), batch["token_type_ids"].long()
                vals.append(float(labert_loss(
                    state.params, featurize(batch), caps, types,
                    step_mask_draws(0, *caps.shape, device), mask_id,
                    num_heads=args.bert_heads)))
        val_loss = float(np.mean(vals)) if vals else float("nan")
        lr = sched.step(val_loss, get_lr(state))
        if lr != get_lr(state):
            state = set_lr(state, lr)
        logger.log({"val_loss": val_loss, "epoch": epoch}, step)
        print(f"epoch {epoch} train {float(loss):.4f} val {val_loss:.4f}")

    # mask-predict decode a few images as a smoke check (skipped when the
    # validation split is empty at tiny dataset sizes)
    sample = next(iter(loader(val_idx, min(4, train_cfg.batch_size), seed=0, shuffle=False,
                              drop_remainder=False)), None)
    if sample is None:
        print("no validation batches; skipping mask-predict smoke")
        return state
    ids = mask_predict_decode(state.params, featurize(sample), mask_id, length=12)
    quality = CaptionMetrics(vocab)
    quality.add_batch_ids(sample["captions"], ids)
    print("mask-predict metrics:", {k: round(v, 4) for k, v in quality.compute().items()})
    return state


if __name__ == "__main__":
    main()
