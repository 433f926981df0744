"""Shared CLI plumbing: args, vocab/data resolution, model construction.

Port of ``captionax/cli/common.py``.  Every
entry point takes real flags instead of hard-coded paths.  A real image
directory (``--img-dir``) is read through ``data/native_image.py``'s file
loader; when the image corpus isn't mounted (``--synthetic``, or missing
paths), runs use deterministic synthetic images over the caption text so
the full pipeline still runs end to end.

The port's conventions: ``--device`` picks the device (default: the card;
``--device cpu`` runs the plain PyTorch versions), and the ``build_*``
functions draw their weights from a ``torch.Generator`` on the host and
place them on ``device``.  :func:`model_generators` gives the two
generators a run draws its decoder and its encoder from, so that
``evaluate`` rebuilds the training run's encoder.

``--mesh-data N`` is data parallelism (``captionax_torch/parallel``): a
training CLI that reads it starts N ranks, one process each, through
``parallel.launch`` (:func:`ranks_to_start`, :func:`run_on_ranks`) and
trains on the ranks' mesh (:func:`resolve_mesh`); ``serve`` shards each
dispatch over N devices in one process.  The other CLIs accept the flag
and run on one device, as captionax's do.  ``train_labert``'s ``--pipe``
and ``--seq`` and ``train_catr``'s ``--pipe`` run the transformer stacks
over a pipeline or sequence mesh of one process (``parallel/pipeline.py``,
``parallel/sequence.py``), its N slots taken from ``default_devices(N,
--device)``: a one-card machine repeats its card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import torch

from captionax_torch.core.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    add_dataclass_args,
    dataclass_from_args,
)
from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.core.vocab import Vocab, build_vocab, load_vocab_pickle
from captionax_torch.data.flickr import (
    FlickrStyleData,
    load_factual_captions,
    load_styled_captions,
)
from captionax_torch.data.synthetic import synthetic_flickr_style
from captionax_torch.models import decoder as dec
from captionax_torch.models.encoder import resnet_init
from captionax_torch.models.hypernet import hypernet_init


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_dataclass_args(p, ModelConfig)
    add_dataclass_args(p, TrainConfig)
    add_dataclass_args(p, DataConfig)
    p.add_argument("--run-name", type=str, default="run")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data parallel over N devices on the 'data' mesh axis "
                        "(0 = one device): the training CLIs start N ranks, one "
                        "process each (NCCL where each rank has a card of its own, "
                        "else gloo), serve shards each dispatch over N devices")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the card, 'cuda'); "
                        "'cpu' runs the plain PyTorch versions of the kernels")
    return p


def ranks_to_start(args) -> int:
    """N for ``--mesh-data N`` above 1 outside a process group (the ranks a
    training CLI must start), else 0."""
    import torch.distributed as dist

    n = getattr(args, "mesh_data", 0)
    return n if n > 1 and not (dist.is_available() and dist.is_initialized()) else 0


def run_on_ranks(main, argv, args):
    """``main(argv)`` on ``--mesh-data`` ranks (``parallel.launch``), each on
    its mesh slot of ``--device``; -> rank 0's result."""
    from captionax_torch.parallel.launch import launch

    argv = list(sys.argv[1:] if argv is None else argv)
    return launch(main, args.mesh_data, (argv,), device=args.device)


def resolve_mesh(args):
    """The data-parallel mesh ``--mesh-data`` asks for (None for 0): the
    ranks' mesh inside a process group, else a one-process mesh over N
    slots of ``--device`` (a one-card machine repeats its card).  Raises
    for ``--mesh-data`` with ``--pipe`` / ``--seq`` above 1: captionax runs
    no data-parallel mesh beside a pipeline or a sequence split (its
    ``train_labert`` and ``train_catr`` ignore ``--mesh-data``)."""
    n = getattr(args, "mesh_data", 0)
    if not n:
        return None
    if getattr(args, "pipe", 1) > 1 or getattr(args, "seq", 1) > 1:
        raise ValueError("--mesh-data does not combine with --pipe or --seq")
    from captionax_torch.parallel.mesh import default_devices, make_mesh

    # the slots run_on_ranks launched the ranks on
    return make_mesh(n_data=n, devices=default_devices(n, args.device))


def parse_configs(args):
    return (
        dataclass_from_args(args, ModelConfig),
        dataclass_from_args(args, TrainConfig),
        dataclass_from_args(args, DataConfig),
    )


def resolve_vocab(data_cfg: DataConfig) -> Vocab:
    if os.path.exists(data_cfg.vocab_path):
        return load_vocab_pickle(data_cfg.vocab_path)
    # rebuild from caption files (build_vocab.py semantics)
    from captionax_torch.core.vocab import extract_factual_caption_lines

    styled = []
    for path in (data_cfg.humour_captions, data_cfg.romantic_captions):
        if os.path.exists(path):
            styled.append(load_styled_captions(path))
    factual = (
        extract_factual_caption_lines(data_cfg.factual_captions)
        if os.path.exists(data_cfg.factual_captions)
        else None
    )
    return build_vocab(factual, styled)


def resolve_flickr_data(data_cfg: DataConfig, vocab, max_len: int) -> FlickrStyleData:
    have_images = os.path.isdir(data_cfg.img_dir) and any(
        os.scandir(data_cfg.img_dir)
    ) if os.path.isdir(data_cfg.img_dir) else False
    if data_cfg.synthetic or not have_images:
        factual_lines = None
        if os.path.exists(data_cfg.factual_captions):
            factual_lines = [
                c for _, c in load_factual_captions(data_cfg.factual_captions)
            ]
        return synthetic_flickr_style(
            num_images=data_cfg.synthetic_images,
            vocab=vocab,
            max_len=max_len,
            factual_lines=factual_lines,
            styled_fixture=data_cfg.styled_fixture,
        )
    from captionax_torch.data.native_image import make_file_loader

    humour = (load_styled_captions(data_cfg.humour_captions)
              if os.path.exists(data_cfg.humour_captions) else [])
    romantic = (load_styled_captions(data_cfg.romantic_captions)
                if os.path.exists(data_cfg.romantic_captions) else [])
    return FlickrStyleData(
        factual=load_factual_captions(data_cfg.factual_captions),
        humour=humour,
        romantic=romantic,
        vocab=vocab,
        image_loader=make_file_loader(data_cfg.img_dir),
        max_len=max_len,
    )


def model_generators(seed: int) -> Tuple[torch.Generator, torch.Generator]:
    """(decoder generator, encoder generator) of a run with ``seed``: two
    independent streams, as captionax splits its key into two."""
    return (torch.Generator().manual_seed(2 * seed),
            torch.Generator().manual_seed(2 * seed + 1))


def build_captioner(model_cfg: ModelConfig, vocab, generator: torch.Generator,
                    device: DeviceLike = None):
    return dec.attention_gru_init(
        generator,
        model_cfg.num_features,
        model_cfg.feature_size,
        model_cfg.embed_size,
        model_cfg.hidden_size,
        len(vocab),
        num_layers=model_cfg.num_layers,
        device=resolve_device(device),
    )


def build_hypernet_model(model_cfg: ModelConfig, vocab, generator: torch.Generator,
                         hyper_emb=None, device: DeviceLike = None):
    dev = resolve_device(device)
    model = {
        "decoder": build_captioner(model_cfg, vocab, generator, dev),
        "hn": hypernet_init(
            generator,
            hyper_emb=hyper_emb or model_cfg.embed_size,
            input_dim=model_cfg.embed_size + model_cfg.feature_size,
            hidden_dim=model_cfg.hidden_size,
            N=model_cfg.hn_n,
            M=model_cfg.hn_m,
            device=dev,
        ),
    }
    if model_cfg.dedicated_style_tokens:
        # 3-row style table (deviation, see steps.dedicated_style_embed)
        from captionax_torch.models.layers import embedding_init

        model["style_embed"] = embedding_init(generator, 3, model_cfg.embed_size,
                                              device=dev)
    return model


def build_encoder(model_cfg: ModelConfig, generator: torch.Generator,
                  torch_weights: str = "", device: DeviceLike = None):
    dev = resolve_device(device)
    if torch_weights and os.path.exists(torch_weights):
        from captionax_torch.models.encoder import from_torch_state_dict

        sd = torch.load(torch_weights, map_location="cpu")
        return from_torch_state_dict(sd, depth=model_cfg.encoder_depth, device=dev)
    return resnet_init(generator, depth=model_cfg.encoder_depth, device=dev)


def maybe_load_glove(params, data_cfg: DataConfig, vocab, embed_size: int):
    """GloVe init of the decoder embedding (the reference's load_glove_emb)
    when the vectors file exists."""
    if data_cfg.glove_path and os.path.exists(data_cfg.glove_path):
        from captionax_torch.data.glove import glove_embedding_matrix

        target = params["decoder"] if "decoder" in params else params
        target["embed"] = glove_embedding_matrix(
            data_cfg.glove_path, vocab, embed_size, device=target["embed"].device)
    return params


def make_encoder(encoder_params, regions: bool = True, device: DeviceLike = None):
    """images uint8 [B, H, W, 3] -> the ResNet's region features [B, R,
    2048], or (``regions=False``) their mean [B, 2048]; the chains run on
    K4, packed once here."""
    from captionax_torch.data.transforms import preprocess_images
    from captionax_torch.models.encoder import CNNEncoder

    dev = resolve_device(device)
    enc = CNNEncoder(encoder_params, device=dev)
    if regions:
        return lambda images: enc(preprocess_images(images, dev))
    return lambda images: enc(preprocess_images(images, dev)).mean(dim=1)


def make_feature_fn(encode, train_cfg: TrainConfig, device: DeviceLike = None):
    """Per-batch featurizer for the CLIs that do not run through
    ``CaptionTrainer`` (``train_lstm``): ``encode(batch["images"])``, or,
    with ``--cache-features`` / ``--cache-features-device``, the harness's
    ``FeatureCache`` keyed by the batch's ``indices`` (each image encoded
    once; the device variant serves warm batches from an f16 table on the
    card).  -> f32 features on ``device``."""
    if not (train_cfg.cache_features or train_cfg.cache_features_device):
        return lambda batch: encode(batch["images"])
    from captionax_torch.train.harness import FeatureCache

    dev = resolve_device(device)
    cache = FeatureCache(lambda _p, imgs: encode(imgs), {},
                         device=train_cfg.cache_features_device)

    def feature_fn(batch):
        if "indices" in batch:
            feats = cache.featurize(lambda: batch["images"], batch["indices"])
            return torch.as_tensor(feats).to(dev)
        return encode(batch["images"])

    return feature_fn
