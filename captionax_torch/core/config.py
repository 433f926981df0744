"""Configuration dataclasses for models and training.

The port's own copy of ``captionax/core/config.py`` (importing anything of
captionax runs its package init, which imports JAX): the same fields, the
same defaults, the same flag mapping.  Every CLI maps flags onto these.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class ModelConfig:
    # reference defaults: HyperNet(200, 200, 200, len(vocab), vocab)
    num_features: int = 2048
    feature_size: int = 200
    embed_size: int = 200
    hidden_size: int = 200
    vocab_size: int = 9684
    num_layers: int = 1
    dropout: float = 0.0
    # hypernet
    hyper_emb: int = 10
    hn_n: int = 1
    hn_m: int = 500
    # encoder
    encoder_depth: int = 152
    regions: int = 49
    # opt-in deviation: condition the hypernet on a dedicated 3-row
    # style table instead of the vocab token row.  The reference uses
    # vocab('humour') which is <unk> (build_vocab never sees the word
    # 'humour'), so humour's conditioning embedding is shared with every
    # OOV word and receives their gradients.  Off by default = exact
    # reference semantics.
    dedicated_style_tokens: bool = False


@dataclass
class TrainConfig:
    lr: float = 5e-3
    batch_size: int = 64
    max_epochs: int = 20
    grad_clip: float = 5.0
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    plateau_cooldown: int = 2
    teacher_forcing_prob: float = 0.0  # reference sample_prob semantics
    # run the exponential LR sweep before fit and install the suggested
    # LR (pl.Trainer auto_lr_find=True + trainer.tune, the reference's
    # default flow)
    auto_lr_find: bool = False
    lr_find_steps: int = 100
    seed: int = 0
    max_len: int = 25
    beam_size: int = 3
    beam_max_steps: int = 50
    # style-classifier objectives of the hypernet (train/steps.py
    # StyleLossStep): the reference's mixup, or captionax's style-aux;
    # at most one.  The *_split flags are read as captionax reads them
    # (and refused with a mesh), but take the same single backward pass:
    # captionax's two-pass gradient was a way round its compiler
    mixup: bool = False
    mixup_alpha: float = 0.3
    mixup_split: bool = False
    style_aux: bool = False
    style_aux_alpha: float = 0.7  # loss = alpha*CE + (1-alpha)*aux
    style_aux_split: bool = False
    style_aux_from_batch: bool = False
    # skip BLEU/METEOR/ROUGE/CIDEr on validation TF logits each epoch
    # (pure-Python, single-core; val_loss/val_loss_tf — the plateau +
    # checkpoint monitors — are unaffected)
    skip_val_quality: bool = False
    log_every: int = 20
    checkpoint_dir: str = "checkpoints"
    # which epoch-end metric BestCheckpointer monitors and its direction
    # (Lightning ModelCheckpoint(monitor=..., mode=...) equivalent);
    # epoch_end_metrics hooks (train/harness.py fit) can supply custom
    # metrics to monitor
    select_metric: str = "val_loss_tf"
    select_mode: str = "min"
    metrics_every_epochs: int = 1
    # mixed-precision training: decoder products and recurrence in
    # bfloat16 with f32 master weights + f32 CE (the reference trains
    # f32 only; numerics differ slightly)
    bf16_compute: bool = False
    # run the teacher-forced recurrence on K3 (ops/train_kernel.py: one
    # CUDA launch over all T steps forward, and the BPTT kernels) instead
    # of the per-step loop — opt-in; values and gradients are held to the
    # loop by the tests
    fused_scan: bool = False
    # unroll factor of the per-step recurrence loop (1 = exact reference
    # loop; kept for flag parity with captionax)
    scan_unroll: int = 1
    # cache frozen-encoder outputs per image in host RAM (f16,
    # ~200 KB/image at 49x2048): the encoder then runs once per image
    # instead of every batch every epoch (the reference recomputes it)
    cache_features: bool = False
    # ... or in an f16 table on the card (no host->card feature traffic
    # once an image is cached)
    cache_features_device: bool = False
    # write a torch.profiler trace of the fit loop to this directory
    # (a Chrome trace; the reference has no profiling at all); empty = off
    trace_dir: str = ""


@dataclass
class DataConfig:
    img_dir: str = "data/flickr7k_images"
    factual_captions: str = "data/factual_train.txt"
    humour_captions: str = "data/humor/funny_train.txt"
    romantic_captions: str = "data/romantic/romantic_train.txt"
    cc_captions: str = "data/200_conceptual_train.txt"
    cc_oneshot_captions: str = "data/one_shot_captions.txt"
    vocab_path: str = "data/vocab.pkl"
    glove_path: str = ""
    synthetic: bool = False
    synthetic_images: int = 64
    # derive humour/romantic lines from each image's real factual
    # caption via the deterministic styled fixture — gives the 3-style
    # hypernet a learnable, measurable style signal
    styled_fixture: bool = False
    domain_scheme: str = "one hot"
    n_tsne: int = 2


def add_dataclass_args(parser, cls, prefix: str = "") -> None:
    for f in dataclasses.fields(cls):
        name = f"--{prefix}{f.name.replace('_', '-')}"
        if f.type == "bool" or f.type is bool:
            parser.add_argument(name, action="store_true", default=f.default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            parser.add_argument(name, type=typ, default=f.default)


def dataclass_from_args(args, cls, prefix: str = ""):
    kwargs = {}
    for f in dataclasses.fields(cls):
        attr = f"{prefix}{f.name}"
        if hasattr(args, attr):
            kwargs[f.name] = getattr(args, attr)
    return cls(**kwargs)
