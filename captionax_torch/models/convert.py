"""Import and export trained checkpoints across the reference's PyTorch
Lightning layout (``.ckpt``).

Port of ``captionax/models/convert.py`` (numpy only there; its own copy
here, returning the port's trees of tensors).  The import side turns a
state_dict saved by the reference trainers -- ``CaptionAttentionGru``
(``captioner.*``), ``HyperNet`` (``captioner.*``, ``hn_base.*``,
``hn_heads.*``) or ``HyperNetCC`` (everything under ``hypernet.``, plus the
domain ``embed``) -- into the tree the port's trainers build and
checkpoint, on an explicit ``device``, every tensor copied exactly:
``nn.Linear`` weights transposed to the ``[in, out]`` layout of
``models/layers.py``, GRU tensors kept in torch's ``[gates*H, in]``.  The
frozen ResNet inside the checkpoint (``image_encoder.resnet.{0..7}``, the
torchvision children ``[:-2]`` in an ``nn.Sequential``) is renamed back
to torchvision's names, which ``models.encoder.from_torch_state_dict``
folds.

The export side is the exact inverse: the port's parameters become a
reference-layout state_dict of CPU tensors that the reference modules
load with ``strict=True`` and that re-imports bit for bit.  The
folded-BN encoder exports as conv kernels with identity BatchNorm
statistics (mean 0, var 1 - eps, weight = scale, bias = bias), the same
function as the folded form.

Not covered, as in captionax: the non-attention ``hypernet.py`` decoders
and the LSTM trainers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device

Params = Dict[str, Any]

# gru.named_parameters() iteration order fixes the hn_heads indexing
# (the reference HyperNet's): weight_ih, weight_hh, bias_ih, bias_hh.
_GRU_TENSORS = ("w_ih", "w_hh", "b_ih", "b_hh")

# EncoderCNN's nn.Sequential(list(resnet.children())[:-2]) positions ->
# torchvision module names (relu/maxpool at 2/3 hold no tensors).
_RESNET_SEQ_NAMES = {
    "0": "conv1",
    "1": "bn1",
    "4": "layer1",
    "5": "layer2",
    "6": "layer3",
    "7": "layer4",
}


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _arr(sd: Dict, name: str, device: DeviceLike = None) -> torch.Tensor:
    """A copy of ``sd[name]``, a contiguous f32 tensor on ``device``."""
    if name not in sd:
        raise KeyError(
            f"checkpoint is missing {name!r} — not a reference-layout "
            f"state_dict? (have e.g. {sorted(sd)[:4]})"
        )
    return torch.from_numpy(np.array(_np(sd[name]), np.float32)).to(resolve_device(device))


def _lin(sd: Dict, name: str, device: DeviceLike = None) -> Params:
    """nn.Linear -> {'w' [in,out], 'b'} (transpose from torch [out,in])."""
    return {"w": _arr(sd, name + ".weight", device).T.contiguous(),
            "b": _arr(sd, name + ".bias", device)}


def _seq_mlp(sd: Dict, name: str, indices=(0, 2), device: DeviceLike = None) -> Params:
    """nn.Sequential of Linears (activations between) -> mlp tree."""
    return {
        f"l{i}": _lin(sd, f"{name}.{idx}", device) for i, idx in enumerate(indices)
    }


def _gru_cell(sd: Dict, name: str, device: DeviceLike = None) -> Params:
    return {
        "w_ih": _arr(sd, name + ".weight_ih", device),
        "w_hh": _arr(sd, name + ".weight_hh", device),
        "b_ih": _arr(sd, name + ".bias_ih", device),
        "b_hh": _arr(sd, name + ".bias_hh", device),
    }


def attention_gru_from_state_dict(
    sd: Dict, prefix: str = "captioner.", device: DeviceLike = None
) -> Params:
    """The reference ``AttentionGru`` -> the tree of
    ``models.decoder.attention_gru_init``.  ``feature_fc`` is
    ``Sequential(Linear, ReLU, Linear)`` (indices 0/2); ``attention`` is
    ``BahdanauAttention`` with W_a/U_a/v_a Linears."""
    p, d = prefix, device
    params: Params = {
        "feature_fc": _seq_mlp(sd, p + "feature_fc", device=d),
        "embed": _arr(sd, p + "embed.weight", d),
        "gru": _gru_cell(sd, p + "gru", d),
        "fc": _lin(sd, p + "fc", d),
        "attention": {
            "W_a": _lin(sd, p + "attention.W_a", d),
            "U_a": _lin(sd, p + "attention.U_a", d),
            "v_a": _lin(sd, p + "attention.v_a", d),
        },
        "init_h": _lin(sd, p + "init_h", d),
    }
    # optional extra GRUCell layers (num_layers > 1)
    layers = []
    while f"{p}layers.{len(layers)}.weight_ih" in sd:
        layers.append(_gru_cell(sd, f"{p}layers.{len(layers)}", d))
    if layers:
        params["layers"] = layers
    return params


def hypernet_from_state_dict(sd: Dict, prefix: str = "", device: DeviceLike = None) -> Params:
    """The reference ``HyperNet``'s base and heads ->
    {'base', 'heads'} as built by
    ``models.hypernet.hypernet_init``.  ``hn_base`` is
    ``Sequential(Linear, LeakyReLU, Linear, LeakyReLU)`` (indices 0/2);
    each head is ``Sequential(Linear, LeakyReLU, Linear)``.
    """
    p = prefix
    return {
        "base": _seq_mlp(sd, p + "hn_base", device=device),
        "heads": {
            name: _seq_mlp(sd, f"{p}hn_heads.{i}", device=device)
            for i, name in enumerate(_GRU_TENSORS)
        },
    }


def domain_embedder_from_state_dict(sd: Dict, prefix: str = "embed",
                                    device: DeviceLike = None) -> Params:
    """The reference ``HyperNetCC.embed`` -> the tree of
    ``data.domains.DomainEmbedder.init_params``.

    Scheme is detected from the keys: ``embed.weight`` = learned
    'embedding' table; ``embed.0/2`` = histogram MLP; ``embed.0`` alone =
    JSD projection; nothing = 'one hot' (a plain tensor attribute, never
    in the state_dict).
    """
    if prefix + ".weight" in sd:
        return {"table": _arr(sd, prefix + ".weight", device)}
    if prefix + ".2.weight" in sd:
        return _seq_mlp(sd, prefix, device=device)
    if prefix + ".0.weight" in sd:
        return _seq_mlp(sd, prefix, indices=(0,), device=device)
    return {}


def encoder_state_dict_from_lightning(
    sd: Dict, prefix: str = "image_encoder.resnet."
) -> Dict[str, torch.Tensor]:
    """Remap ``EncoderCNN``'s Sequential-indexed keys back to torchvision
    names (``0.weight`` -> ``conv1.weight``, ``4.0.conv1.weight`` ->
    ``layer1.0.conv1.weight``) for
    ``models.encoder.from_torch_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        idx, _, tail = rest.partition(".")
        name = _RESNET_SEQ_NAMES.get(idx)
        if name is None:  # relu/maxpool hold no tensors; skip trackers
            continue
        out[f"{name}.{tail}" if tail else name] = torch.from_numpy(
            np.ascontiguousarray(_np(value)))
    return out


def detect_kind(sd: Dict) -> str:
    """'gru' | 'hypernet' | 'hypernet_cc' from the state_dict keys."""
    if any(k.startswith("hypernet.") for k in sd):
        return "hypernet_cc"
    if any(k.startswith("hn_base.") for k in sd):
        return "hypernet"
    if any(k.startswith("captioner.gru.") for k in sd):
        return "gru"
    raise ValueError(
        "unrecognized checkpoint layout — expected CaptionAttentionGru, "
        "HyperNet (attention) or HyperNetCC keys; got e.g. "
        f"{sorted(sd)[:6]}"
    )


def import_lightning_state_dict(
    sd: Dict, device: DeviceLike = None,
) -> Tuple[str, Params, Optional[Dict[str, torch.Tensor]]]:
    """-> (kind, the port's params on ``device``, the torchvision-named
    encoder state_dict of CPU tensors, or None without ``image_encoder.*``
    keys).

    The params tree is the one the port's trainers build and checkpoint
    (``cli/common.py``'s ``build_captioner`` / ``build_hypernet_model``,
    ``cli/cc_train_hypernet.py``'s ``build_cc_model_and_embedder``), so it
    restores in ``cli/evaluate``, ``cli/caption`` and ``CaptionTrainer``.
    """
    kind = detect_kind(sd)
    if kind == "gru":
        params: Params = attention_gru_from_state_dict(sd, device=device)
        enc_prefix = "image_encoder.resnet."
    elif kind == "hypernet":
        params = {
            "decoder": attention_gru_from_state_dict(sd, device=device),
            "hn": hypernet_from_state_dict(sd, device=device),
        }
        enc_prefix = "image_encoder.resnet."
    else:  # hypernet_cc: everything nests under `hypernet.`
        params = {
            "decoder": attention_gru_from_state_dict(sd, "hypernet.captioner.", device),
            "hn": hypernet_from_state_dict(sd, "hypernet.", device),
            "domain_emb": domain_embedder_from_state_dict(sd, device=device),
        }
        # the train and validation steps run self.hypernet.image_encoder;
        # both copies are the same frozen trunk, prefer the one exercised
        enc_prefix = "hypernet.image_encoder.resnet."
        if not any(k.startswith(enc_prefix) for k in sd):
            enc_prefix = "image_encoder.resnet."
    encoder_sd = encoder_state_dict_from_lightning(sd, enc_prefix) or None
    return kind, params, encoder_sd


def load_lightning_checkpoint(path: str, device: DeviceLike = None) -> Dict[str, Any]:
    """Read a Lightning ``.ckpt`` (a ``torch.save`` of 'state_dict' and
    'hyper_parameters', or of a bare state_dict) and convert it.
    -> {'kind', 'params', 'encoder_state_dict', 'hparams'}."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    kind, params, encoder_sd = import_lightning_state_dict(sd, device)
    hparams = blob.get("hyper_parameters", {}) if isinstance(blob, dict) else {}
    return {
        "kind": kind,
        "params": params,
        "encoder_state_dict": encoder_sd,
        "hparams": dict(hparams),
    }


# ---------------------------------------------------------------------------
# Export: the port's params -> reference-layout state_dict
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    """A contiguous f32 CPU tensor of ``a`` (a tensor anywhere, or an array)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(_np(a), np.float32)))


def _lin_sd(sd: Dict, name: str, p: Params) -> None:
    """Inverse of :func:`_lin`: {'w' [in,out], 'b'} -> torch Linear keys."""
    sd[name + ".weight"] = _t(_np(p["w"]).T)
    sd[name + ".bias"] = _t(p["b"])


def _seq_mlp_sd(sd: Dict, name: str, p: Params, indices=(0, 2)) -> None:
    for i, idx in enumerate(indices):
        _lin_sd(sd, f"{name}.{idx}", p[f"l{i}"])


def _gru_sd(sd: Dict, name: str, p: Params) -> None:
    for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                         ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
        sd[f"{name}.{theirs}"] = _t(p[ours])


def attention_gru_to_state_dict(
    params: Params, prefix: str = "captioner."
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`attention_gru_from_state_dict`: keys that load into
    the reference ``AttentionGru`` with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    p = prefix
    _seq_mlp_sd(sd, p + "feature_fc", params["feature_fc"])
    sd[p + "embed.weight"] = _t(params["embed"])
    _gru_sd(sd, p + "gru", params["gru"])
    _lin_sd(sd, p + "fc", params["fc"])
    for name in ("W_a", "U_a", "v_a"):
        _lin_sd(sd, p + "attention." + name, params["attention"][name])
    _lin_sd(sd, p + "init_h", params["init_h"])
    for i, layer in enumerate(params.get("layers", [])):
        _gru_sd(sd, f"{p}layers.{i}", layer)
    return sd


def hypernet_to_state_dict(
    params: Params, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`hypernet_from_state_dict` (hn_base, and hn_heads
    in the reference's ``gru.named_parameters()`` order)."""
    sd: Dict[str, torch.Tensor] = {}
    _seq_mlp_sd(sd, prefix + "hn_base", params["base"])
    for i, name in enumerate(_GRU_TENSORS):
        _seq_mlp_sd(sd, f"{prefix}hn_heads.{i}", params["heads"][name])
    return sd


def domain_embedder_to_state_dict(
    emb: Params, prefix: str = "embed"
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`domain_embedder_from_state_dict` (the scheme from
    the tree's shape, as the import reads it from the keys)."""
    sd: Dict[str, torch.Tensor] = {}
    if not emb:
        return sd
    if "table" in emb:
        sd[prefix + ".weight"] = _t(emb["table"])
    elif "l1" in emb:
        _seq_mlp_sd(sd, prefix, emb)
    else:
        _seq_mlp_sd(sd, prefix, emb, indices=(0,))
    return sd


def encoder_state_dict_from_params(
    enc_params: Dict, eps: float = 1e-5
) -> Dict[str, torch.Tensor]:
    """Folded-BN encoder params -> torchvision-named state_dict.

    BatchNorms are emitted with identity statistics (running_mean=0,
    running_var=1-eps, weight=scale, bias=bias), so torchvision's
    ``y = (conv - mean)/sqrt(var + eps) * weight + bias`` is the folded
    ``conv*scale + bias``; re-importing through
    ``models.encoder.from_torch_state_dict`` gives the params back bit for
    bit.
    """
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(conv_name: str, bn_name: str, p: Dict) -> None:
        # HWIO -> torch OIHW
        sd[conv_name + ".weight"] = _t(np.transpose(_np(p["kernel"]), (3, 2, 0, 1)))
        n = p["scale"].shape[0]
        sd[bn_name + ".weight"] = _t(p["scale"])
        sd[bn_name + ".bias"] = _t(p["bias"])
        sd[bn_name + ".running_mean"] = torch.zeros((n,), dtype=torch.float32)
        sd[bn_name + ".running_var"] = torch.full((n,), 1.0 - eps, dtype=torch.float32)

    conv_bn("conv1", "bn1", enc_params["stem"])
    for s, blocks in enumerate(enc_params["stages"]):
        for b, block in enumerate(blocks):
            base = f"layer{s + 1}.{b}"
            for c in (1, 2, 3):
                conv_bn(f"{base}.conv{c}", f"{base}.bn{c}", block[f"conv{c}"])
            if "downsample" in block:
                conv_bn(f"{base}.downsample.0", f"{base}.downsample.1", block["downsample"])
    return sd


_RESNET_NAME_TO_SEQ = {v: k for k, v in _RESNET_SEQ_NAMES.items()}


def trunk_to_lightning(trunk: Dict, kind: str) -> Dict[str, torch.Tensor]:
    """A torchvision-named ResNet state_dict -> the Lightning module's
    ``image_encoder.resnet.<Sequential index>.*`` keys (``hypernet.`` first
    for ``hypernet_cc``); ``fc`` and other heads ``EncoderCNN`` drops are
    left out."""
    prefix = ("hypernet.image_encoder.resnet." if kind == "hypernet_cc"
              else "image_encoder.resnet.")
    out = {}
    for name, value in trunk.items():
        mod, _, tail = name.partition(".")
        seq = _RESNET_NAME_TO_SEQ.get(mod)
        if seq is not None:
            out[f"{prefix}{seq}.{tail}"] = torch.as_tensor(_np(value)).contiguous()
    return out


def export_lightning_state_dict(
    kind: str,
    params: Params,
    encoder_params: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`import_lightning_state_dict`: the port's params
    (and optionally the folded encoder) -> one reference-layout state_dict
    of CPU tensors that :func:`detect_kind` recognizes and the reference
    Lightning modules load.  ``kind`` is 'gru' | 'hypernet' | 'hypernet_cc'.
    """
    if kind == "gru":
        sd = attention_gru_to_state_dict(params)
    elif kind == "hypernet":
        sd = attention_gru_to_state_dict(params["decoder"])
        sd.update(hypernet_to_state_dict(params["hn"]))
    elif kind == "hypernet_cc":
        sd = attention_gru_to_state_dict(params["decoder"], "hypernet.captioner.")
        sd.update(hypernet_to_state_dict(params["hn"], "hypernet."))
        sd.update(domain_embedder_to_state_dict(params.get("domain_emb", {})))
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if encoder_params is not None:
        sd.update(trunk_to_lightning(encoder_state_dict_from_params(encoder_params), kind))
    return sd
