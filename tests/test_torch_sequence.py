"""The port's sequence and expert parallelism
(captionax_torch/parallel/sequence.py) on the CPU against captionax's over
its virtual 8-device CPU mesh, every case of tests/test_sequence.py: the
seq-sharded BERT encoder, all-gather and ring, forward under padding and
causal masks and without a mask, through the gradient, on a data x seq
mesh, and plugged into labert_forward; an indivisible token axis raises;
the expert-sharded theta bank against captionax's and against
``synthesize_theta_batched``.  Same weights (captionax's init carried with
``from_jax_params``), same inputs.  Forward atol 2e-5 / rtol 2e-5,
gradients atol 5e-5 / rtol 5e-4, the bank atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import transformer as jtr
from captionax.parallel import sequence as jseq
from captionax_torch.interop import from_jax_params
from captionax_torch.models import transformer as ttr
from captionax_torch.parallel import sequence as tseq
from captionax_torch.train.state import tree_leaves
from captionax_torch.train.steps import _value_and_grad

torch.set_num_threads(1)
HEADS, DIM, FF, L, B, T = 4, 32, 64, 4, 8, 16
CPU8 = ["cpu"] * 8
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-4)


def T_(x):
    return torch.from_numpy(np.array(x))


def port_mesh(n_seq, n_data=1, axis="seq"):
    return tseq.sequence_mesh(n_seq, n_data, seq_axis=axis, devices=CPU8)


@pytest.fixture(scope="module")
def layers():
    jl = jtr.bert_encoder_init(jax.random.PRNGKey(0), L, DIM, HEADS, FF)
    return jl, from_jax_params(jax.tree_util.tree_map(np.asarray, jl), "cpu")


@pytest.fixture(scope="module")
def x():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, T, DIM)))


@pytest.fixture(scope="module")
def pad_mask():
    keep = np.ones((B, T), np.float32)
    keep[::2, -3:] = 0.0
    return ((1.0 - keep)[:, None, None, :] * -10000.0).astype(np.float32)


def both(layers, x, mask, ring, n_data=1):
    """(port, captionax sharded, captionax dense) encoder outputs."""
    jl, tl = layers
    data = "data" if n_data > 1 else None
    jenc = jseq.sequence_parallel_bert_encoder(jseq.sequence_mesh(n_seq=4, n_data=n_data),
                                               HEADS, data_axis=data, ring=ring)
    tenc = tseq.sequence_parallel_bert_encoder(port_mesh(4, n_data), HEADS, data_axis=data,
                                               ring=ring)
    jm = None if mask is None else jnp.asarray(mask)
    ref = jax.jit(lambda xx: jenc(jl, xx, HEADS, jm))(jnp.asarray(x))
    dense = jtr.bert_encoder(jl, jnp.asarray(x), HEADS, jm)
    got = tenc(tl, T_(x), HEADS, None if mask is None else T_(mask))
    return got.detach().numpy(), np.asarray(ref), np.asarray(dense)


class TestSequenceParallel:
    @pytest.mark.parametrize("ring", [False, True])
    def test_matches_dense(self, layers, x, pad_mask, ring):
        got, ref, dense = both(layers, x, pad_mask, ring)
        np.testing.assert_allclose(got, ref, **FWD)
        np.testing.assert_allclose(got, dense, **FWD)

    @pytest.mark.parametrize("ring", [False, True])
    def test_causal_mask(self, layers, x, ring):
        mask = np.asarray(jtr.causal_mask(T))
        np.testing.assert_array_equal(ttr.causal_mask(T, "cpu").numpy(), mask)
        got, ref, dense = both(layers, x, mask, ring)
        np.testing.assert_allclose(got, ref, **FWD)
        np.testing.assert_allclose(got, dense, **FWD)

    @pytest.mark.parametrize("ring", [False, True])
    def test_grad_matches_dense(self, layers, x, pad_mask, ring):
        jl, tl = layers
        tgt = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, T, DIM)))
        jenc = jseq.sequence_parallel_bert_encoder(jseq.sequence_mesh(n_seq=4), HEADS,
                                                   ring=ring)
        tenc = tseq.sequence_parallel_bert_encoder(port_mesh(4), HEADS, ring=ring)

        def jloss(ps, encoder):
            return jnp.mean((encoder(ps, jnp.asarray(x), HEADS, jnp.asarray(pad_mask)) - tgt)
                            ** 2)

        g_dense = jax.grad(jloss)(jl, jtr.bert_encoder)
        g_sp = jax.jit(jax.grad(jloss), static_argnums=1)(jl, jenc)
        _, g = _value_and_grad(
            lambda ps: torch.mean((tenc(ps, T_(x), HEADS, T_(pad_mask)) - T_(tgt)) ** 2), tl)
        for a, b, c in zip(tree_leaves(g), jax.tree_util.tree_leaves(g_sp),
                           jax.tree_util.tree_leaves(g_dense)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **GRAD)

    @pytest.mark.parametrize("ring", [False, True])
    def test_composes_with_data_axis(self, layers, x, pad_mask, ring):
        got, ref, dense = both(layers, x, pad_mask, ring, n_data=2)
        np.testing.assert_allclose(got, ref, **FWD)
        np.testing.assert_allclose(got, dense, **FWD)

    @pytest.mark.parametrize("ring", [False, True])
    def test_mask_none(self, layers, x, ring):
        got, ref, dense = both(layers, x, None, ring)
        np.testing.assert_allclose(got, ref, **FWD)
        np.testing.assert_allclose(got, dense, **FWD)

    def test_indivisible_token_axis_raises(self, layers, pad_mask):
        enc = tseq.sequence_parallel_bert_encoder(port_mesh(4), HEADS)
        with pytest.raises(ValueError, match="not divisible"):
            enc(layers[1], torch.zeros((B, T + 2, DIM)), HEADS, T_(pad_mask))

    def test_mask_rows(self):
        pad = torch.zeros((2, 1, 1, 8))
        assert tseq._mask_rows(pad, 4, 4) is pad and tseq._mask_rows(None, 0, 4) is None
        causal = ttr.causal_mask(8, "cpu")
        assert torch.equal(tseq._mask_rows(causal, 4, 4), causal[:, :, 4:8])

    @pytest.mark.parametrize("ring", [False, True])
    def test_labert_forward_matches(self, ring):
        """labert_forward with the seq-sharded encoder_fn (4 image + 12 text
        = 16 tokens, seq 4, the text's last two columns padded) against
        captionax's sharded and sequential forwards."""
        from captionax.models import labert as jlab
        from captionax_torch.models import labert as tlab

        params = jlab.labert_init(jax.random.PRNGKey(0), vocab_size=64, hidden=32,
                                  num_layers=4, num_heads=4, intermediate=64,
                                  max_position=32, num_regions=4, image_dim=16)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
        Bq, Tt = 4, 12
        feats = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (Bq, 4, 16)))
        ids = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (Bq, Tt), 0, 64))
        types = np.zeros((Bq, Tt), np.int32)
        amask = np.ones((Bq, Tt), np.float32)
        amask[:, -2:] = 0.0
        ref = jlab.labert_forward(params, feats, ids, types, amask, num_heads=4)
        jenc = jseq.sequence_parallel_bert_encoder(jseq.sequence_mesh(n_seq=4), 4, ring=ring)
        jout = jax.jit(lambda p: jlab.labert_forward(p, feats, ids, types, amask, num_heads=4,
                                                     encoder_fn=jenc))(params)
        enc = tseq.sequence_parallel_bert_encoder(port_mesh(4), 4, ring=ring)
        got = tlab.labert_forward(tp, T_(feats), T_(ids).long(), T_(types).long(), T_(amask),
                                  num_heads=4, encoder_fn=enc).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jout), **FWD)
        np.testing.assert_allclose(got, np.asarray(ref), **FWD)


class TestExpertParallel:
    def hypernet(self):
        from captionax.models.hypernet import hypernet_init

        hn = hypernet_init(jax.random.PRNGKey(0), hyper_emb=16, input_dim=24, hidden_dim=24)
        return {"hn": hn}, {"hn": from_jax_params(jax.tree_util.tree_map(np.asarray, hn),
                                                  "cpu")}

    def test_bank_matches_batched_synthesis(self):
        from captionax.train.steps import synthesize_theta_batched as jsynth
        from captionax_torch.train.steps import synthesize_theta_batched as tsynth

        jp, tp = self.hypernet()
        embeds = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 16)))
        ref = jax.jit(jsynth)(jp, jnp.asarray(embeds))
        jbank = jax.jit(jseq.expert_theta_bank(jseq.sequence_mesh(n_seq=4, seq_axis="expert"),
                                               "expert"))(jp, jnp.asarray(embeds))
        bank = tseq.expert_theta_bank(port_mesh(4, axis="expert"), "expert")(tp, T_(embeds))
        plain = tsynth(tp, T_(embeds))
        assert set(bank) == set(ref)
        for k in ref:
            np.testing.assert_allclose(bank[k].detach().numpy(), np.asarray(ref[k]), atol=1e-6)
            np.testing.assert_allclose(bank[k].detach().numpy(), np.asarray(jbank[k]),
                                       atol=1e-6)
            np.testing.assert_allclose(bank[k].detach().numpy(), plain[k].detach().numpy(),
                                       atol=1e-6)

    def test_indivisible_bank_raises(self):
        _, tp = self.hypernet()
        synth = tseq.expert_theta_bank(port_mesh(4, axis="expert"), "expert")
        with pytest.raises(ValueError, match="not divisible"):
            synth(tp, torch.zeros((6, 16)))
