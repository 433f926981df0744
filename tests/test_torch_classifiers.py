"""The port's style classifiers (captionax_torch/models/classifiers.py) on
the CPU against captionax's, on the same weights (carried with
from_jax_params) and the same numpy inputs, at hidden 32, 2 layers, V=40.
Probabilities and trunk outputs within rtol 1e-5, atol 1e-5 (f32 sums
taken in another order); the one-hot soft inputs against the hard ids of
the port itself within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import classifiers as jclf
from captionax_torch.interop import from_jax_params
from captionax_torch.models import classifiers as tclf
from captionax_torch.train import state as tstate

torch.set_num_threads(1)
V, HID, LAYERS, B, T, EMB = 40, 32, 2, 4, 6, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


def ids_and_mask(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, V, (B, T)).astype(np.int32)
    ids[1, 4:] = 0  # padded tails
    ids[3, 2:] = 0
    return ids, (ids != 0).astype(np.float32)


def soft_tokens(seed):
    logits = np.random.RandomState(seed).randn(B, T, V).astype(np.float32) * 2
    return np.asarray(jax.nn.softmax(logits, axis=-1))


@pytest.fixture(scope="module")
def bert():
    return np_tree(jclf.style_classifier_init(jax.random.PRNGKey(0), V, 3, HID, LAYERS))


@pytest.fixture(scope="module")
def small():
    return np_tree(jclf.small_style_classifier_init(jax.random.PRNGKey(1), V, EMB, 3))


@pytest.fixture(scope="module")
def essence():
    return np_tree(jclf.essence_classifier_init(jax.random.PRNGKey(2), V, HID, LAYERS))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("heads", [None, 4])
def test_bert_trunk_apply(bert, heads):
    ids, mask = ids_and_mask(3)
    seq, pooled = jclf.bert_trunk_apply(bert["bert"], ids, mask, heads)
    tseq, tpooled = tclf.bert_trunk_apply(carry(bert["bert"]), t(ids), t(mask), heads)
    close(tseq, seq)
    close(tpooled, pooled)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_trunk_apply_soft(bert, masked):
    probs = soft_tokens(4)
    mask = ids_and_mask(5)[1] if masked else None
    seq, pooled = jclf.bert_trunk_apply_soft(bert["bert"], probs, mask)
    tseq, tpooled = tclf.bert_trunk_apply_soft(carry(bert["bert"]), t(probs),
                                               None if mask is None else t(mask))
    close(tseq, seq)
    close(tpooled, pooled)


def test_style_classifier_apply(bert):
    ids, mask = ids_and_mask(6)
    close(tclf.style_classifier_apply(carry(bert), t(ids), t(mask)),
          jclf.style_classifier_apply(bert, ids, mask))


def test_style_classifier_apply_soft(bert):
    probs = soft_tokens(7)
    close(tclf.style_classifier_apply_soft(carry(bert), t(probs)),
          jclf.style_classifier_apply_soft(bert, probs))


def test_essence_classifier_apply(essence):
    a, ma = ids_and_mask(8)
    b, mb = ids_and_mask(9)
    close(tclf.essence_classifier_apply(carry(essence), t(a), t(ma), t(b), t(mb)),
          jclf.essence_classifier_apply(essence, a, ma, b, mb))


def test_small_style_classifier_apply(small):
    ids, _ = ids_and_mask(10)
    close(tclf.small_style_classifier_apply(carry(small), t(ids)),
          jclf.small_style_classifier_apply(small, ids))


def test_small_style_classifier_apply_soft(small):
    probs = soft_tokens(11)
    close(tclf.small_style_classifier_apply_soft(carry(small), t(probs)),
          jclf.small_style_classifier_apply_soft(small, probs))


@pytest.mark.parametrize("kind", ["bert", "small"])
def test_dispatchers(kind, bert, small):
    params = bert if kind == "bert" else small
    probs = soft_tokens(12)
    ids, _ = ids_and_mask(13)
    soft, hard = tclf.classifier_soft_apply_fn(carry(params)), tclf.classifier_ids_apply_fn(
        carry(params))
    assert soft is (tclf.style_classifier_apply_soft if kind == "bert"
                    else tclf.small_style_classifier_apply_soft)
    close(soft(carry(params), t(probs)), jclf.classifier_soft_apply_fn(params)(params, probs))
    close(hard(carry(params), t(ids)), jclf.classifier_ids_apply_fn(params)(params, ids))


@pytest.mark.parametrize("kind", ["bert", "small"])
def test_one_hot_soft_equals_hard(kind, bert, small):
    """Soft tokens that are one-hot give the hard apply's probabilities
    (the BERT soft apply masks nothing, so the hard one gets all ids
    non-zero)."""
    params = carry(bert if kind == "bert" else small)
    ids = t(np.random.RandomState(14).randint(1, V, (B, T)).astype(np.int32))
    one_hot = torch.nn.functional.one_hot(ids.long(), V).float()
    soft = tclf.classifier_soft_apply_fn(params)(params, one_hot)
    hard = tclf.classifier_ids_apply_fn(params)(params, ids)
    close(soft, hard.numpy(), rtol=1e-6, atol=1e-6)


def test_dropout_off_equals_no_dropout(bert):
    ids, mask = ids_and_mask(15)
    p = carry(bert)
    plain = tclf.style_classifier_apply(p, t(ids), t(mask))
    g = torch.Generator().manual_seed(0)
    off = tclf.style_classifier_apply(p, t(ids), t(mask), dropout_generator=g, dropout=0.0)
    assert torch.equal(plain, off)
    assert g.initial_seed() == 0 and torch.equal(  # the rate 0 drew nothing
        torch.rand(3, generator=g), torch.rand(3, generator=torch.Generator().manual_seed(0)))


def test_dropout_draws_from_its_generator(bert):
    ids, mask = ids_and_mask(16)
    p = carry(bert)
    run = lambda seed: tclf.style_classifier_apply(  # noqa: E731
        p, t(ids), t(mask), dropout_generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    close(a.sum(-1), np.ones(B))


def test_inits_match_captionax_structure():
    g = torch.Generator().manual_seed(0)
    pairs = [
        (tclf.style_classifier_init(g, V, 4, HID, LAYERS, device="cpu"),
         jclf.style_classifier_init(jax.random.PRNGKey(0), V, 4, HID, LAYERS)),
        (tclf.essence_classifier_init(g, V, HID, LAYERS, device="cpu"),
         jclf.essence_classifier_init(jax.random.PRNGKey(0), V, HID, LAYERS)),
        (tclf.small_style_classifier_init(g, V, EMB, 3, device="cpu"),
         jclf.small_style_classifier_init(jax.random.PRNGKey(0), V, EMB, 3)),
    ]
    for got, ref in pairs:
        assert ([tuple(x.shape) for x in tstate.tree_leaves(got)]
                == [np.shape(x) for x in jax.tree_util.tree_leaves(ref)])
        assert all(x.dtype == torch.float32 for x in tstate.tree_leaves(got))
    small = pairs[2][0]
    assert float(small["fc"]["w"].abs().max()) <= 0.5 and not small["fc"]["b"].any()
    assert abs(float(pairs[0][0]["bert"]["word_emb"].std()) - 0.02) < 0.005


def hf_state_dict(seed):
    """A seeded state dict with HuggingFace BertModel's names and shapes."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(name, i, o):
        sd[name + ".weight"] = torch.randn((o, i), generator=g)
        sd[name + ".bias"] = torch.randn((o,), generator=g)

    def ln(name):
        sd[name + ".weight"] = 1 + 0.1 * torch.randn((HID,), generator=g)
        sd[name + ".bias"] = 0.1 * torch.randn((HID,), generator=g)

    sd["embeddings.word_embeddings.weight"] = torch.randn((V, HID), generator=g)
    sd["embeddings.position_embeddings.weight"] = torch.randn((64, HID), generator=g)
    sd["embeddings.token_type_embeddings.weight"] = torch.randn((2, HID), generator=g)
    ln("embeddings.LayerNorm")
    for i in range(LAYERS):
        p = f"encoder.layer.{i}"
        for part in ("query", "key", "value"):
            lin(f"{p}.attention.self.{part}", HID, HID)
        lin(f"{p}.attention.output.dense", HID, HID)
        ln(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", HID, 4 * HID)
        lin(f"{p}.output.dense", 4 * HID, HID)
        ln(f"{p}.output.LayerNorm")
    lin("pooler.dense", HID, HID)
    return sd


def test_bert_trunk_from_hf_state_dict():
    """The same trunk as captionax's conversion, every weight transposed
    into [in, out]; and the same outputs on it."""
    sd = hf_state_dict(17)
    ref = np_tree(jclf.bert_trunk_from_hf_state_dict(sd, HID, LAYERS))
    got = tclf.bert_trunk_from_hf_state_dict(sd, HID, LAYERS, device="cpu")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_flat = tstate.tree_leaves(got)
    assert len(ref_flat) == len(got_flat)
    for (path, a), b in zip(ref_flat, got_flat):
        assert torch.equal(b, t(a)), jax.tree_util.keystr(path)
    assert torch.equal(got["encoder"][1]["ffn"]["w1"]["w"],
                       sd["encoder.layer.1.intermediate.dense.weight"].T)
    ids, mask = ids_and_mask(18)
    close(tclf.bert_trunk_apply(got, t(ids), t(mask))[1],
          jclf.bert_trunk_apply(jax.tree_util.tree_map(jnp.asarray, ref), ids, mask)[1])
