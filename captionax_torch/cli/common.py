"""Shared CLI plumbing: args, vocab/data resolution, model construction.

Port of the parts of ``captionax/cli/common.py`` that ``train_gru``,
``train_hypernet`` and ``evaluate`` use.  Every entry point takes real
flags instead of hard-coded paths.  When the image corpus isn't mounted
(``--synthetic``, or missing paths), runs use deterministic synthetic
images over the caption text so the full pipeline still runs end to end.

The port's conventions: ``--device`` picks the device (default: the card;
``--device cpu`` runs the plain PyTorch versions), and the ``build_*``
functions draw their weights from a ``torch.Generator`` on the host and
place them on ``device``.  :func:`model_generators` gives the two
generators a run draws its decoder and its encoder from, so that
``evaluate`` rebuilds the training run's encoder.  ``--mesh-data`` other
than 0 raises: data parallelism is ``ROADMAP.md`` queue 1 item 9.
"""

from __future__ import annotations

import argparse
import os
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
                   help="shard batches over N devices (0 = single device); "
                        "not ported yet, anything but 0 raises")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the card, 'cuda'); "
                        "'cpu' runs the plain PyTorch versions of the kernels")
    return p


def resolve_mesh(args):
    """None for ``--mesh-data 0``; data parallelism is not ported yet."""
    n = getattr(args, "mesh_data", 0)
    if n:
        raise NotImplementedError(
            f"--mesh-data {n}: data parallelism is not ported yet "
            "(ROADMAP.md queue 1 item 9)")
    return None


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
    # a real image directory needs the image loader of data/native_image.py,
    # which comes with the next slice (ROADMAP.md queue 1 item 3)
    raise NotImplementedError(
        f"{data_cfg.img_dir}: loading real image files is not ported yet "
        "(ROADMAP.md queue 1 item 3); pass --synthetic")


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
