"""Train the non-attention hypernet captioner (the original HyperNet).

Port of ``captionax/cli/train_captioning.py``: a ResNet global-feature
encoder with a trainable projection, and a cell-level GRU or LSTM decoder
(step 0 consumes the image feature) whose cell weights — every layer's,
with ``--num-layers`` > 1 — come from the v0 hypernet, under a decaying
teacher-forcing probability: each step is teacher-forced with probability
p (numpy's ``RandomState(seed).binomial``), and p <- p * ``--tf-decay``
while p > ``--tf-floor``.  Runs on the card unless ``--device cpu`` is
given.

captionax's choices kept: ``fc_out`` gets a zero gradient before the clip,
so it stays bit-equal to its random init (``--train-fc-out`` trains it);
the loss is the mean CE over every position, pads included
(``--masked-loss`` ignores the pads); the GRU decoder draws a uniform
random h0 every step, the LSTM starts from zeros.

Randomness.  Step ``s`` draws its h0 and the Gumbel noise of its sampled
tokens (:func:`step_draws`) from a generator on the run's device seeded
from ``--seed`` and ``s``; captionax draws them from ``PRNGKey(s)``.  The
frozen encoder is ``resnet_apply(...).mean((1, 2))``, its bottleneck
chains on K4, packed once per run.  The optimizer updates the state in
place (``make_optimizer(donate=True)``): at the CLI defaults (E = H =
200, V = 9684) the model has 3.657 B parameters, and the parameters, the
gradients and Adam's two moments take 58.5 GB.

    python -m captionax_torch.cli.train_captioning --synthetic --cell gru --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from captionax_torch.cli.common import (
    build_encoder,
    make_encoder,
    make_parser,
    model_generators,
    parse_configs,
    resolve_flickr_data,
    resolve_mesh,
    resolve_vocab,
)
from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.data.loader import BatchLoader
from captionax_torch.models.cell_decoders import (
    cell_decoder_forward,
    cell_decoder_init,
    gumbel_noise,
)
from captionax_torch.models.hypernet import hypernet_v0_apply, hypernet_v0_init
from captionax_torch.models.layers import embedding
from captionax_torch.train.harness import step_generator
from captionax_torch.train.logging import MetricLogger
from captionax_torch.train.losses import cross_entropy_loss
from captionax_torch.train.state import create_train_state, get_lr, make_optimizer
from captionax_torch.train.steps import _value_and_grad


def build_capgru_model(generator: torch.Generator, E: int, H: int, V: int, cell: str = "gru",
                       num_layers: int = 1, device: DeviceLike = None):
    """The captioner's parameters: the trainable projection of the ResNet
    feature, the cell decoder (its own cell tensors exist but are shadowed
    by the generated theta) and the v0 hypernet."""
    dev = resolve_device(device)
    gates = 3 if cell == "gru" else 4
    proj_w = torch.randn((2048, E), generator=generator) * 0.02
    return {
        "proj": {"w": proj_w.to(dev), "b": torch.zeros((E,), device=dev)},
        "decoder": cell_decoder_init(generator, E, H, V, cell=cell, num_layers=num_layers,
                                     device=dev),
        "hn": hypernet_v0_init(generator, hyper_emb=E, input_dim=E, hidden_dim=H,
                               gates=gates, num_layers=num_layers, device=dev),
    }


def capgru_loss(params, feats2048, captions, style_id, *, cell: str, teacher_forcing: bool,
                pad_id, h0=None, gumbel=None):
    """theta = hn(embed[style]); the CE of the multi-layer cell decoder
    under that theta.  ``h0`` (the GRU's) and ``gumbel`` (the sampled
    steps' noise, [T, B, V]) are the step's draws."""
    feat = feats2048 @ params["proj"]["w"] + params["proj"]["b"]
    style_embed = embedding(params["decoder"]["embed"], style_id)
    thetas = hypernet_v0_apply(params["hn"], style_embed)
    logits = cell_decoder_forward(params["decoder"], feat, captions, cell=cell,
                                  teacher_forcing=teacher_forcing, cell_params=thetas,
                                  h0=h0, gumbel=gumbel)
    return cross_entropy_loss(logits, captions, pad_id=pad_id)


def freeze_fc_out(grads):
    """Zero the fc_out gradients (in place): fc_out is never in the
    reference's optimizer, so it stays at its init."""
    for g in grads["decoder"]["fc_out"].values():
        g.zero_()
    return grads


def step_draws(seed: int, step: int, shape, cell: str, teacher_forcing: bool,
               device: DeviceLike = None):
    """Step ``step``'s (h0 or None, Gumbel noise or None): h0 ~ U[0, 1)
    [B, H] for the GRU, the noise [T, B, V] for a sampled step.
    ``shape`` is (B, T, H, V)."""
    B, T, H, V = shape
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(
        int(step_generator(seed, step).initial_seed()))
    h0 = torch.rand((B, H), generator=g, device=dev) if cell == "gru" else None
    gumbel = None if teacher_forcing else gumbel_noise(g, (T, B, V), dev)
    return h0, gumbel


def make_train_step(tx, *, cell: str, pad_id, train_fc_out: bool):
    """``train_step(state, feats2048, captions, style_id, teacher_forcing,
    h0, gumbel) -> (state, loss)``."""
    def train_step(state, feats2048, captions, style_id, teacher_forcing, h0, gumbel):
        loss, grads = _value_and_grad(
            lambda p: capgru_loss(p, feats2048, captions, style_id, cell=cell,
                                  teacher_forcing=teacher_forcing, pad_id=pad_id,
                                  h0=h0, gumbel=gumbel), state.params)
        if not train_fc_out:
            grads = freeze_fc_out(grads)
        return state.apply_gradients(grads, tx), loss

    return train_step


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--cell", type=str, default="gru", choices=["gru", "lstm"])
    parser.add_argument("--tf-decay", type=float, default=0.9995)
    parser.add_argument("--tf-floor", type=float, default=0.25)
    parser.add_argument("--encoder-weights", type=str, default="")
    parser.add_argument("--train-fc-out", action="store_true",
                        help="deviation: also train fc_out (the reference "
                             "freezes it at random init)")
    parser.add_argument("--masked-loss", action="store_true",
                        help="deviation: ignore pad positions in the CE "
                             "(the reference passes no ignore_index)")
    args = parser.parse_args(argv)
    model_cfg, train_cfg, data_cfg = parse_configs(args)
    resolve_mesh(args)
    device = resolve_device(args.device)

    vocab = resolve_vocab(data_cfg)
    V = len(vocab)
    data = resolve_flickr_data(data_cfg, vocab, train_cfg.max_len)
    E, H = model_cfg.embed_size, model_cfg.hidden_size
    print(f"cell={args.cell} layers={model_cfg.num_layers} vocab={V} "
          f"images={len(data)}")

    g_model, g_encoder = model_generators(train_cfg.seed)
    params = build_capgru_model(g_model, E, H, V, cell=args.cell,
                                num_layers=model_cfg.num_layers, device=device)
    encode = make_encoder(build_encoder(model_cfg, g_encoder, args.encoder_weights, device),
                          regions=False, device=device)

    tx = make_optimizer(train_cfg.lr, train_cfg.grad_clip, donate=True)
    state = create_train_state(params, tx, device=device)
    del params
    logger = MetricLogger(train_cfg.checkpoint_dir, args.run_name)
    cell = args.cell
    pad_id = vocab.w2i["<pad>"] if args.masked_loss else None
    train_step = make_train_step(tx, cell=cell, pad_id=pad_id, train_fc_out=args.train_fc_out)

    train_idx, _, _ = data.splits(seed=train_cfg.seed)
    tf_proba = 1.0
    step = 0
    loss = torch.tensor(float("nan"))
    rng_py = np.random.RandomState(train_cfg.seed)
    for epoch in range(train_cfg.max_epochs):
        for batch in BatchLoader(
            data.batches(train_idx, train_cfg.batch_size, style="random",
                         seed=train_cfg.seed + epoch), device=device,
        ):
            feats = encode(batch["images"])
            teacher_forcing = bool(rng_py.binomial(1, tf_proba))
            captions = batch["captions"].long()
            B, T = captions.shape
            h0, gumbel = step_draws(train_cfg.seed, step, (B, T, H, V), cell,
                                    teacher_forcing, device)
            style_id = torch.as_tensor(np.asarray(batch["style_id"]), device=device).long()
            state, loss = train_step(state, feats, captions, style_id, teacher_forcing,
                                     h0, gumbel)
            if tf_proba > args.tf_floor:
                tf_proba *= args.tf_decay
            step += 1
            if step % train_cfg.log_every == 0:
                logger.log({"train_loss": float(loss),
                            "tf_proba": tf_proba, "epoch": epoch}, step)
        print(f"epoch {epoch} loss {float(loss):.4f} lr {get_lr(state):.2e} "
              f"p_tf {tf_proba:.3f}")
    return state


if __name__ == "__main__":
    main()
