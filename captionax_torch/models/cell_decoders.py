"""Cell-level decoders: the captioners whose cell weights the v0 (non-
attention) hypernet generates, and the Show-Attend-Tell decoder.

Port of ``captionax/models/cell_decoders.py``.  Their time loops are Python
loops over the steps; captionax runs them as ``lax.scan``s, with no Pallas
kernel, and the port has none either.

- :func:`cell_decoder_forward`: a GRU or LSTM cell (with extra layers fed
  ``layer(h, h)``, a reference quirk); step 0 consumes the image feature,
  step t > 0 ``embed(captions[:, t-1])`` (teacher forcing) or a sample of
  the previous step's softmax; :func:`cell_decoder_infer` feeds back the
  argmax.  ``random_h0`` keeps the GRU decoder's uniform-random initial
  state.
- :func:`show_attend_tell_forward` / :func:`show_attend_tell_sample`: an
  LSTM over ``[embed, sigmoid(f_beta(h)) * context]`` with the gated ReLU
  attention.

Randomness is an input.  The initial state ``h0`` and the Gumbel noise of
the sampled steps (``gumbel`` [T, B, V]) may be given; where they are not,
they are drawn from ``generator``: ``h0`` ~ U[0, 1), and the noise
``-log(-log(u))`` of :func:`gumbel_noise`.  A sampled step takes ``argmax(noise + logits)``,
which is how captionax's ``jax.random.categorical`` samples, so the CPU
tests pass in captionax's own draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from captionax_torch.core.runtime import DeviceLike, resolve_device
from captionax_torch.models.attention import gated_attention, gated_attention_init
from captionax_torch.models.layers import (
    embedding,
    embedding_init,
    linear,
    linear_init,
    uniform,
)
from captionax_torch.models.rnn import gru_cell, gru_cell_init, lstm_cell, lstm_cell_init

Params = Dict[str, object]


def gumbel_noise(generator: torch.Generator, shape, device: DeviceLike = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u ~ U[tiny, 1), drawn on the
    generator's device and moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.clamp_(min=torch.finfo(u.dtype).tiny)
    return u.log_().neg_().log_().neg_().to(resolve_device(device))


def cell_decoder_init(
    generator: torch.Generator,
    embed_size: int,
    hidden_size: int,
    vocab_size: int,
    cell: str = "gru",
    num_layers: int = 1,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    init = gru_cell_init if cell == "gru" else lstm_cell_init
    params: Params = {
        "cell": init(generator, embed_size, hidden_size, dtype, device),
        "fc_out": linear_init(generator, hidden_size, vocab_size, dtype, device),
        "embed": embedding_init(generator, vocab_size, embed_size, dtype, device),
    }
    if num_layers > 1:
        params["layers"] = [init(generator, hidden_size, hidden_size, dtype, device)
                            for _ in range(num_layers - 1)]
    return params


def _step(params, cell: str, x, state, cell_params=None):
    """One multi-layer cell step.  ``cell_params`` is a single theta (layer
    0; the extra layers from ``params['layers']``) or a list of per-layer
    thetas (the v0 hypernet generates every layer).  Extra layers take the
    running hidden state as input and state: ``layer(h, h)``."""
    if isinstance(cell_params, (list, tuple)):
        layer_ps = list(cell_params)
    else:
        layer_ps = [params["cell"] if cell_params is None else cell_params]
        layer_ps.extend(params.get("layers", ()))
    if cell == "gru":
        h = gru_cell(layer_ps[0], x, state)
        for extra in layer_ps[1:]:
            h = gru_cell(extra, h, h)
        return h, h
    h, c = lstm_cell(layer_ps[0], x, state)
    for extra in layer_ps[1:]:
        h, c = lstm_cell(extra, h, (h, c))
    return h, (h, c)


def _initial_state(cell: str, B: int, H: int, device, random_h0: bool,
                   generator: Optional[torch.Generator], h0: Optional[torch.Tensor]):
    if h0 is None:
        if random_h0 and generator is not None:
            h0 = torch.rand((B, H), generator=generator, device=generator.device)
        else:
            h0 = torch.zeros((B, H))
    h0 = h0.to(device)
    return h0 if cell == "gru" else (h0, torch.zeros((B, H), device=device))


def cell_decoder_forward(
    params: Params,
    features: torch.Tensor,  # [B, E] global image feature
    captions: torch.Tensor,  # [B, T]
    cell: str = "gru",
    teacher_forcing: bool = True,
    generator: Optional[torch.Generator] = None,
    random_h0: bool = False,
    cell_params=None,
    h0: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> logits [B, T, V].  Step 0 consumes the feature; step t > 0
    ``embed(captions[:, t-1])`` under teacher forcing, else the
    ``argmax(noise_t + logits_{t-1})`` sample.  Without noise or a generator
    every step is teacher-forced, as captionax's is without a key."""
    B, T = captions.shape
    H = params["fc_out"]["w"].shape[0]
    dev = features.device
    state = _initial_state(cell, B, H, dev, random_h0, generator, h0)
    sample = not teacher_forcing and (gumbel is not None or generator is not None)
    embeds = None if sample else embedding(params["embed"], captions.long())
    logits, out = None, []
    for t in range(T):
        if t == 0:
            x = features
        elif sample:
            noise = gumbel_noise(generator, logits.shape, dev) if gumbel is None else gumbel[t]
            x = embedding(params["embed"], torch.argmax(noise.to(dev) + logits, dim=-1))
        else:
            x = embeds[:, t - 1]
        h, state = _step(params, cell, x, state, cell_params)
        logits = linear(params["fc_out"], h)
        out.append(logits)
    return torch.stack(out, dim=1)


def cell_decoder_infer(
    params: Params,
    features: torch.Tensor,
    max_len: int = 50,
    cell: str = "gru",
    end_id: int = 2,
    cell_params=None,
    random_h0: bool = False,
    generator: Optional[torch.Generator] = None,
    h0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy inference: the feature first, then argmax feedback.  ->
    ids [B, max_len] int32, 0 after a row's ``end_id``."""
    B = features.shape[0]
    H = params["fc_out"]["w"].shape[0]
    dev = features.device
    state = _initial_state(cell, B, H, dev, random_h0, generator, h0)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok, out = None, []
    for t in range(max_len):
        x = features if t == 0 else embedding(params["embed"], tok)
        h, state = _step(params, cell, x, state, cell_params)
        tok = torch.argmax(linear(params["fc_out"], h), dim=-1)
        out.append(torch.where(done, torch.zeros_like(tok), tok))
        done = done | (tok == end_id)
    return torch.stack(out, dim=1).to(torch.int32)


# ------------------------------------------- Show-Attend-Tell decoder ---
def show_attend_tell_init(
    generator: torch.Generator,
    encoder_dim: int,
    embed_dim: int,
    decoder_dim: int,
    attention_dim: int,
    vocab_size: int,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Params:
    """The embedding and ``fc``'s weight U(-0.1, 0.1), ``fc``'s bias 0 (the
    reference's init_weights)."""
    g = generator
    params = {
        "attention": gated_attention_init(g, encoder_dim, decoder_dim, attention_dim, device),
        "embed": uniform(g, (vocab_size, embed_dim), 0.1, device, dtype),
        "lstm": lstm_cell_init(g, embed_dim + encoder_dim, decoder_dim, dtype, device),
        "init_h": linear_init(g, encoder_dim, decoder_dim, dtype, device),
        "init_c": linear_init(g, encoder_dim, decoder_dim, dtype, device),
        "f_beta": linear_init(g, decoder_dim, encoder_dim, dtype, device),
        "fc": {"w": uniform(g, (decoder_dim, vocab_size), 0.1, device, dtype),
               "b": torch.zeros((vocab_size,), dtype=dtype, device=resolve_device(device))},
    }
    return params


def _sat_init_state(params, encoder_out):
    mean_enc = encoder_out.mean(dim=1)
    return linear(params["init_h"], mean_enc), linear(params["init_c"], mean_enc)


def _sat_step(params, encoder_out, word_embed, h, c):
    ctx, alpha = gated_attention(params["attention"], encoder_out, h)
    gate = torch.sigmoid(linear(params["f_beta"], h))
    x = torch.cat([word_embed, gate * ctx], dim=-1)
    h, c = lstm_cell(params["lstm"], x, (h, c))
    return h, c, linear(params["fc"], h), alpha


def show_attend_tell_forward(
    params: Params,
    encoder_out: torch.Tensor,  # [B, R, encoder_dim]
    captions: torch.Tensor,     # [B, T]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass -> (logits [B, T-1, V], alphas [B, T-1, R]):
    step t consumes ``embed(captions[:, t])`` and predicts
    ``captions[:, t+1]``."""
    T = captions.shape[1]
    h, c = _sat_init_state(params, encoder_out)
    embeds = embedding(params["embed"], captions.long())
    logits, alphas = [], []
    for t in range(T - 1):
        h, c, lg, alpha = _sat_step(params, encoder_out, embeds[:, t], h, c)
        logits.append(lg)
        alphas.append(alpha)
    return torch.stack(logits, dim=1), torch.stack(alphas, dim=1)


def show_attend_tell_sample(
    params: Params, encoder_out: torch.Tensor, max_len: int = 20,
    bos_id: int = 1, end_id: int = 2,
) -> torch.Tensor:
    """Greedy sample from ``<s>`` -> ids [B, max_len] int32, 0 after a
    row's ``end_id``."""
    B = encoder_out.shape[0]
    dev = encoder_out.device
    h, c = _sat_init_state(params, encoder_out)
    tok = torch.full((B,), bos_id, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = []
    for _ in range(max_len):
        h, c, lg, _ = _sat_step(params, encoder_out, embedding(params["embed"], tok), h, c)
        tok = torch.argmax(lg, dim=-1)
        out.append(torch.where(done, torch.zeros_like(tok), tok))
        done = done | (tok == end_id)
    return torch.stack(out, dim=1).to(torch.int32)
