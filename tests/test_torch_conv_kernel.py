"""K4's plain version against captionax's fused-bottleneck Pallas kernel.

``captionax_torch.ops.conv_kernel.fused_stage_plain`` (what the CUDA
kernels of ``csrc/conv_stage.cu`` compute, and what ``fused_stage`` runs
for CPU tensors) against ``captionax.ops.conv_kernel.fused_stage`` in
interpret mode, on depth-50 ResNet blocks at small spatial sizes.  Every
folded scale and bias is drawn from a seed first: ``resnet_init`` zeroes the
conv3 scales, which makes every block ReLU(identity) and hides a wrong
conv1, conv2 or conv3.  Tolerances: f32 atol = rtol = 1e-4 (captionax's own,
tests/test_conv_kernel.py); bf16 within 2e-2 of the output's largest entry
(products of the same bf16 values summed in another order can flip a
rounding, which later blocks carry along).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import encoder as jenc
from captionax.ops import conv_kernel as jck
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import conv_kernel as ck

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def captionax_resnet(depth: int, key: int = 0):
    """captionax's ``resnet_init`` (jitted: one compile, not one per shape;
    cached, so the test files of one worker share it)."""
    return jax.jit(jenc.resnet_init, static_argnums=1)(jax.random.PRNGKey(key), depth)


def randomize_bn(tree, seed: int):
    """Every folded scale/bias of a captionax ResNet tree drawn from a seed
    (conv3 scales in [0.1, 0.2], the others in [0.5, 1.5], biases N(0, 0.1)),
    as numpy arrays."""
    rs = np.random.RandomState(seed)

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if "kernel" in node:
            c = node["scale"].shape[0]
            lo, hi = (0.1, 0.2) if name == "conv3" else (0.5, 1.5)
            return {"kernel": np.asarray(node["kernel"]),
                    "scale": rs.uniform(lo, hi, c).astype(np.float32),
                    "bias": rs.normal(0.0, 0.1, c).astype(np.float32)}
        return {k: walk(v, k) for k, v in node.items()}

    return walk(tree)


@pytest.fixture(scope="module")
def resnet50():
    return randomize_bn(captionax_resnet(50), seed=1)


# (stage, blocks, B, S): stage 1 with its projection, an identity chain of
# stage-2 blocks, one stage-3 block without a projection
CASES = {
    "stage1_projection": (0, slice(0, 3), 3, 8),
    "stage2_identity_chain": (1, slice(1, 3), 2, 4),
    "stage3_single_block": (2, slice(1, 2), 2, 2),
}


def _case(resnet50, name, seed):
    s, sl, b, size = CASES[name]
    blocks = resnet50["stages"][s][sl]
    cin = blocks[0]["conv1"]["kernel"].shape[2]
    x = np.maximum(np.random.RandomState(seed).randn(b, size, size, cin), 0).astype(np.float32)
    return blocks, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_stage_equals_captionax(resnet50, name):
    blocks, _ = _case(resnet50, name, 0)
    ref = jck.pack_stage(blocks)
    got = ck.pack_stage(from_jax_params(blocks, device="cpu"))
    assert set(got) == set(ref)
    for key, arr in ref.items():
        if arr is None:
            assert got[key] is None, key
        else:
            assert tuple(got[key].shape) == arr.shape, key
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr), err_msg=key)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(resnet50, name, f32):
    blocks, x = _case(resnet50, name, 2)
    ref = np.asarray(jck.fused_stage(jnp.asarray(x), jck.pack_stage(blocks), interpret=True,
                                     f32=f32), np.float32)
    got = ck.fused_stage_plain(torch.from_numpy(x), ck.pack_stage(from_jax_params(blocks,
                                                                                  device="cpu")),
                               f32=f32)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if f32:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_chain_is_not_relu_of_its_input(resnet50, f32):
    """With nonzero conv3 scales an identity chain moves its input: a K4
    that skipped conv1-conv3 would return ReLU(x) and fail here."""
    blocks, x = _case(resnet50, "stage2_identity_chain", 3)
    got = ck.fused_stage_plain(torch.from_numpy(x), ck.pack_stage(from_jax_params(
        blocks, device="cpu")), f32=f32).float().numpy()
    assert np.abs(got - np.maximum(x, 0)).max() > 0.05 * np.abs(x).max()


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(resnet50):
    blocks, x = _case(resnet50, "stage1_projection", 4)
    packed = ck.pack_stage(from_jax_params(blocks, device="cpu"))
    before = [op.launches for op in ck.KERNELS]
    got = ck.fused_stage(torch.from_numpy(x), packed, f32=True)
    want = ck.fused_stage_plain(torch.from_numpy(x), packed, f32=True)
    assert torch.equal(got, want)
    assert [op.launches for op in ck.KERNELS] == before


def test_wrapper_raises_off_cpu_and_cuda(resnet50):
    blocks, x = _case(resnet50, "stage3_single_block", 5)
    packed = ck.pack_stage(from_jax_params(blocks, device="cpu"))
    with pytest.raises(ValueError, match="no kernel"):
        ck.fused_stage(torch.from_numpy(x).to("meta"), packed)


def test_pack_stage_casts_weights_not_scales(resnet50):
    blocks, _ = _case(resnet50, "stage1_projection", 0)
    packed = ck.pack_stage(from_jax_params(blocks, device="cpu"), torch.bfloat16)
    for key, t in packed.items():
        want = torch.float32 if key.startswith("sb") else torch.bfloat16
        assert t.dtype == want, key


# The four ResNet-152 chains at the caption service's batch of 64 images:
# (rows = 64 * S * S, M, C), and the bf16 tile widths (N = M, N = C) that
# were fastest, or level with the fastest, per stage on an H100 (PERF.md)
STAGE_SHAPES = {"stage1": (64 * 56 * 56, 64, 256, (64, 256)),
                "stage2": (64 * 28 * 28, 128, 512, (128, 256)),
                "stage3": (64 * 14 * 14, 256, 1024, (256, 256)),
                "stage4": (64 * 7 * 7, 512, 2048, (128, 256))}


def _rounds_cost(rows, n, bn):
    row_tiles = -(-rows // ck.TILE_ROWS)
    return -(-row_tiles * (n // bn) // ck.SMS) * (bn + ck.TILE_ROWS)


@pytest.mark.parametrize("name", sorted(STAGE_SHAPES))
def test_tile_width_at_batch_64(name):
    """At B=64 every launch of a chain gets the measured width; its grid
    covers the rows and columns, and every launch fills at least three
    quarters of the 132 SMs (stage 3's N=M products: 98 blocks of 256,
    faster than 196 of 128, which take two rounds)."""
    rows, M, C, want = STAGE_SHAPES[name]
    got = (ck.tile_width(rows, M), ck.tile_width(rows, C))
    assert got == want
    for n, bn in zip((M, C), got):
        row_tiles = -(-rows // ck.TILE_ROWS)
        assert row_tiles * ck.TILE_ROWS >= rows > (row_tiles - 1) * ck.TILE_ROWS
        assert n % bn == 0
        assert row_tiles * (n // bn) >= 0.74 * ck.SMS


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 3 * 7 * 7, 5 * 56 * 56])
@pytest.mark.parametrize("n", [64, 128, 192, 256, 512, 2048])
def test_tile_width_covers_small_and_ragged_launches(rows, n):
    """At any row count the width is one the kernel takes, divides n (the
    kernel has no ragged column edge), and no other such width needs fewer
    rounds of tiles x cost; on a tie the wider wins."""
    bn = ck.tile_width(rows, n)
    assert bn in ck.TILE_WIDTHS and n % bn == 0
    for w in ck.TILE_WIDTHS:
        if n % w == 0:
            assert _rounds_cost(rows, n, bn) <= _rounds_cost(rows, n, w)
            if _rounds_cost(rows, n, bn) == _rounds_cost(rows, n, w):
                assert bn >= w
