"""The port's bf16 decodes against captionax's bf16 decodes, on the CPU.

captionax's bf16 kernels (``fused_greedy`` and ``fused_beam_search`` with
``f32=False``, in interpret mode) take the attention's tanh, the scores and
the context in bf16 and round x and h to bf16 before the gate products; the
port's bf16 decode (its plain versions with bf16 weights, carried by
``from_jax_params``) computes in f32 from bf16 weights and features.  The
two functions differ, so they are held by agreement rate and score gap, not
token for token: at a narrow width (NF=64, F=E=H=32, V=301, B=64, 9
regions), on seeds whose captions run long,

- greedy: at least 90% of rows equal (measured 96.9-100%);
- beam: at least 90% of images with equal tokens and found flags (measured
  96.9-100%), and scores within 2e-3 where both found the same caption
  (measured at most 3.9e-4);
- the port's bf16 decode agrees with captionax's bf16 decode at least as
  often as the port's f32 decode does.
"""

import jax
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.ops import decode_kernel as jdk
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
NF, F, E, H, V, B, R = 64, 32, 32, 32, 301, 64, 9
MIN_AGREEMENT = 0.9
SCORE_GAP = 2e-3


def make(seed, eos_bias):
    params = jdec.attention_gru_init(jax.random.PRNGKey(seed), NF, F, E, H, V)
    params["fc"]["b"] = params["fc"]["b"].at[2].add(eos_bias)
    raw = np.random.RandomState(seed + 100).randn(B, R, NF).astype(np.float32)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, tp, raw


@pytest.mark.parametrize("seed,bias", [(5, 0.35), (7, 0.45), (11, 0.3)])
def test_greedy_bf16_agrees_with_captionax_bf16(seed, bias):
    params, tp, raw = make(seed, bias)
    ref = np.asarray(jdk.fused_greedy(params, raw, max_len=20, block_rows=8, interpret=True,
                                      f32=False))
    got = tdk.fused_greedy(tp, torch.from_numpy(raw), max_len=20, device="cpu").numpy()
    f32 = tdk.fused_greedy(tp, torch.from_numpy(raw), max_len=20, f32=True, device="cpu").numpy()
    agree = (got == ref).all(axis=1).mean()
    assert agree >= MIN_AGREEMENT
    assert agree >= (f32 == ref).all(axis=1).mean()


@pytest.mark.parametrize("seed,bias", [(7, 0.45), (13, 0.4)])
def test_beam_bf16_agrees_with_captionax_bf16(seed, bias):
    params, tp, raw = make(seed, bias)
    ref = jdk.fused_beam_search(params, raw, max_steps=20, block_images=8, interpret=True,
                                f32=False)
    rt, rf, rs = (np.asarray(x) for x in (ref.tokens, ref.found, ref.scores))

    def same(res):
        return ((res.tokens.numpy() == rt).reshape(B, -1).all(axis=1)
                & (res.found.numpy() == rf))

    got = tdk.fused_beam_search(tp, torch.from_numpy(raw), max_steps=20, device="cpu")
    f32 = tdk.fused_beam_search(tp, torch.from_numpy(raw), max_steps=20, f32=True, device="cpu")
    agree = same(got)
    assert agree.mean() >= MIN_AGREEMENT
    assert agree.mean() >= same(f32).mean()
    both = agree & rf
    assert both.any()
    assert np.abs(got.scores.numpy()[both] - rs[both]).max() <= SCORE_GAP
