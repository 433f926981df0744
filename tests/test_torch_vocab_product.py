"""The bf16 vocab products of K1 and K2, on the CPU.

With bf16 weights, ``logits_top3_partial`` and ``logits_top1_partial`` run
on the tensor cores with h_new split into three bf16 terms, hi = bf16(h),
mid = bf16(h - hi), lo = bf16(h - hi - mid)
(``captionax_torch/ops/csrc/decode_common.cuh``).  A plain PyTorch mirror
of that split, used by these tests only, shows that the terms keep h's f32
value and that their products with bf16 fc_w sum to the f32 product that
captionax's kernels take (``jnp.dot`` of f32 h and bf16 fc_w, promoted to
f32).  Also here: the kernels' host-side tiling rule
(``vocab_items_per_block``) at the row counts of the service and of
chip_smoke.py's edge sweep, and the exact operands of that sweep, whose
logits chip_smoke.py requires the kernels to reproduce bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from captionax_torch.ops import decode_kernel as tdk

torch.set_num_threads(1)
EDGE_ROWS = (1, 3, 63, 64, 65, 127, 129, 192, 1024, 3072)


def split3(x: torch.Tensor):
    """The kernels' split of f32 x into bf16 hi, mid, lo."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def values(kind: str, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    if kind == "uniform":  # (-1, 1), the range of a GRU state
        x = rs.uniform(-1, 1, 200_000)
    elif kind == "tanh":  # what h_new is
        x = np.tanh(rs.randn(200_000) * 2)
    else:  # magnitudes 2^-60 .. 2^60, both signs
        x = np.exp2(rs.uniform(-60, 60, 200_000)) * rs.choice([-1.0, 1.0], 200_000)
    x = x.astype(np.float32)
    x[:4] = [0.0, np.float32(1 - 2 ** -24), -np.float32(1 - 2 ** -24), 2 ** -7 + 2 ** -16]
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["uniform", "tanh", "wide"])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_terms_reconstruct_f32_exactly(kind, seed):
    x = values(kind, seed)
    hi, mid, lo = split3(x)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # each term is the rounding of what the earlier ones leave: |mid| <= |hi| 2^-8
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("kind", ["uniform", "tanh"])
def test_two_terms_are_not_enough(kind):
    """Why the kernels keep three terms: hi + mid loses bits of h."""
    x = values(kind, 2)
    hi, mid, _ = split3(x)
    assert not torch.equal(hi.float() + mid.float(), x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_term_products_sum_to_the_f32_product(seed):
    """At H=200, with fc_w at the decoder's init scale: the three term
    products sum exactly to h @ fc_w (in f64; rounded once to f32 they are
    the f32 product, bit for bit).  Accumulated in f32 as the kernels do
    (one accumulator), and captionax's f32 product (``jnp.dot`` of f32 h and
    bf16 fc_w), each take their own f32 rounding of 600 or 200 sums: they
    agree within 2e-6 at these |logits| < 2 (f32 spacing 2.4e-7 there).
    The product of bf16(h), another function, is off by more than 1e-4."""
    rs = np.random.RandomState(seed)
    h = np.tanh(rs.randn(64, 200)).astype(np.float32)
    w = jnp.asarray(rs.uniform(-1, 1, (200, 384)) / np.sqrt(200), dtype=jnp.bfloat16)
    ref = np.asarray(jnp.dot(jnp.asarray(h), w, preferred_element_type=jnp.float32))
    wt = torch.from_numpy(np.array(w.astype(jnp.float32)))
    ht = torch.from_numpy(h)
    terms = split3(ht)
    exact = torch.matmul(ht.double(), wt.double())
    summed = sum(torch.matmul(t.double(), wt.double()) for t in terms)
    np.testing.assert_allclose(summed.numpy(), exact.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(summed.float(), exact.float())
    one_acc = torch.matmul(torch.cat([t.float() for t in terms], 1), torch.cat([wt] * 3, 0))
    np.testing.assert_allclose(one_acc.numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(summed.float().numpy(), ref, rtol=0, atol=2e-6)
    bf16_h = torch.matmul(terms[0].float(), wt)
    assert (bf16_h - torch.tensor(ref)).abs().max().item() > 1e-4


@pytest.mark.parametrize("hd", [24, 200])
@pytest.mark.parametrize("rows", [3, 129])
def test_exact_operands_are_exact(monkeypatch, rows, hd):
    """chip_smoke.py's exact operands: the logits are the same in f32 in any
    order of the sums (here the term products of the split, the plain
    version's product, and f64), and h's entries use all three terms."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    h, w, b = chip_smoke.exact_operands(rows, hd, 384, 5)
    ref = torch.matmul(h.double(), w.double()) + b.double()
    plain = torch.matmul(h, w.float()) + b
    terms = sum(torch.matmul(t.float(), w.float()) for t in reversed(split3(h))) + b
    assert torch.equal(plain.double(), ref)
    assert torch.equal(terms.double(), ref)
    assert chip_smoke.lo_share(h) > 0.9
    assert ref.abs().max().item() < 16
    got = tdk.logits_top3_partial_plain(h, w, b)
    assert torch.equal(got[2].double(), ref.reshape(rows, 3, 128).max(dim=2).values)


def assignment(rows: int, n_chunks: int, per_block: int):
    """The kernel's items of each block: items b * per_block .. + per_block
    of ceil(rows / 128) * n_chunks, row-tile-major."""
    items = -(-rows // tdk.VOCAB_ROWS) * n_chunks
    blocks = -(-items // per_block)
    return items, [range(b * per_block, min((b + 1) * per_block, items)) for b in range(blocks)]


@pytest.mark.parametrize("n_chunks", [1, 3, 76])
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_items_per_block_fill_one_wave(rows, n_chunks):
    """Every item lies in exactly one nonempty block, the blocks fit in one
    wave of the card's SMs (132 on the H100 SXM, 114 on the PCIe card), and
    no smaller count would; a block meets at most two row tiles while it
    takes at most n_chunks items."""
    for sms in (132, 114):
        per = tdk.vocab_items_per_block(rows, n_chunks, sms)
        items, blocks = assignment(rows, n_chunks, per)
        assert per >= 1 and len(blocks) <= sms
        assert per == 1 or -(-items // (per - 1)) > sms
        assert sorted(i for blk in blocks for i in blk) == list(range(items))
        assert all(len(blk) > 0 for blk in blocks)
        if per <= n_chunks:
            assert all(len({i // n_chunks for i in blk}) <= 2 for blk in blocks)


@pytest.mark.parametrize("rows,per,blocks", [(3072, 14, 131), (1024, 5, 122), (192, 2, 76),
                                             (64, 1, 76), (3, 1, 76)])
def test_items_per_block_at_the_served_batches(rows, per, blocks):
    """At V=9684 (76 chunks) on 132 SMs: B=1024 beam (3072 rows) and greedy,
    the service's B=64 beam (192 rows) and greedy, and a lone beam request."""
    assert tdk.vocab_items_per_block(rows, 76, 132) == per
    assert len(assignment(rows, 76, per)[1]) == blocks


def test_bf16_kernels_take_h_up_to_256():
    """The bf16 wrappers' extra argument, and their refusal of an h whose
    three terms do not fit in shared memory (checked before any launch)."""
    w = torch.zeros((300, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no bf16 vocab kernel"):
        tdk._vocab_args(torch.zeros((1, 300)), w, torch.device("cpu"), 1, 1)
    assert tdk._vocab_args(torch.zeros((1, 300)), w.float(), torch.device("cpu"), 1, 1) == ()
