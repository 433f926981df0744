"""The port's model functions against captionax's, on the same weights
(carried with from_jax_params) and the same numpy inputs, in f32 on the
CPU.  Tolerance: atol 1e-5 (f32 sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import attention as jatt
from captionax.models import decoder as jdec
from captionax.models import hypernet as jhn
from captionax.models import layers as jlayers
from captionax.models import rnn as jrnn
from captionax.train import steps as jsteps
from captionax_torch.interop import from_jax_params
from captionax_torch.models import attention as tatt
from captionax_torch.models import decoder as tdec
from captionax_torch.models import hypernet as thn
from captionax_torch.models import layers as tlayers
from captionax_torch.models import rnn as trnn
from captionax_torch.train import steps as tsteps

torch.set_num_threads(1)
ATOL = 1e-5
NF, F, E, H, V, B, R = 32, 16, 16, 16, 50, 4, 5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    return from_jax_params(np_tree(tree), device="cpu")


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def decoder_params(num_layers=1):
    return jdec.attention_gru_init(jax.random.PRNGKey(3), NF, F, E, H, V,
                                   num_layers=num_layers)


def hypernet_params(M=50):
    return jhn.hypernet_init(jax.random.PRNGKey(4), hyper_emb=E, input_dim=E + F,
                             hidden_dim=H, M=M)


def case_linear():
    p = jlayers.linear_init(jax.random.PRNGKey(0), 8, 5)
    x = rand(0, 3, 8)
    return jlayers.linear(p, x), tlayers.linear(carry(p), t(x))


def case_embedding():
    table = rand(1, 20, 6)
    ids = np.array([3, 0, 19, 3], np.int32)
    return jlayers.embedding(table, ids), tlayers.embedding(t(table), t(ids).long())


def case_mlp():
    p = jlayers.mlp_init(jax.random.PRNGKey(1), (8, 12, 4))
    x = rand(2, 3, 8)
    return jlayers.mlp(p, x), tlayers.mlp(carry(p), t(x))


def case_mlp_final_act():
    p = jlayers.mlp_init(jax.random.PRNGKey(1), (8, 12, 4))
    x = rand(2, 3, 8)
    return (jlayers.mlp(p, x, final_act=True),
            tlayers.mlp(carry(p), t(x), final_act=True))


def case_gru_cell_shared():
    p = jrnn.gru_cell_init(jax.random.PRNGKey(2), 10, 7)
    x, h = rand(3, 4, 10), rand(4, 4, 7)
    return jrnn.gru_cell(p, x, h), trnn.gru_cell(carry(p), t(x), t(h))


def case_gru_cell_per_row():
    cells = [jrnn.gru_cell_init(jax.random.PRNGKey(10 + i), 10, 7) for i in range(4)]
    p = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *cells)
    x, h = rand(5, 4, 10), rand(6, 4, 7)
    return jrnn.gru_cell(p, x, h), trnn.gru_cell(carry(p), t(x), t(h))


def case_bahdanau_attention():
    p = jatt.bahdanau_init(jax.random.PRNGKey(5), F, H)
    f, h = rand(7, B, R, F), rand(8, B, H)
    return (jnp.concatenate(jatt.bahdanau_attention(p, f, h), axis=1),
            torch.cat(tatt.bahdanau_attention(carry(p), t(f), t(h)), dim=1))


def case_encode_features():
    p = decoder_params()
    raw = rand(9, B, R, NF)
    return jdec.encode_features(p, raw), tdec.encode_features(carry(p), t(raw))


def case_attention_pre():
    p = decoder_params()
    f, h = rand(10, B, R, F), rand(11, B, H)
    att1 = jlayers.linear(p["attention"]["W_a"], f)
    tp = carry(p)
    return (jnp.concatenate(jdec._attention_pre(p["attention"], att1, f, h), axis=1),
            torch.cat(tdec._attention_pre(tp["attention"], t(att1), t(f), t(h)), dim=1))


def case_init_hidden_extra_layers():
    p = decoder_params(num_layers=3)
    f = rand(12, B, R, F)
    return jdec.init_hidden(p, f), tdec.init_hidden(carry(p), t(f))


def case_decode_step():
    p = decoder_params(num_layers=2)
    w, h, f = rand(13, B, E), rand(14, B, H), rand(15, B, R, F)
    ref = jdec.decode_step(p, w, h, f)
    got = tdec.decode_step(carry(p), t(w), t(h), t(f))
    return jnp.concatenate(ref, axis=1), torch.cat(got, dim=1)


def case_decode_step_hypernet_theta():
    p, hn = decoder_params(), hypernet_params()
    theta = jhn.hypernet_apply(hn, jnp.asarray(rand(16, E)))
    w, h, f = rand(17, B, E), rand(18, B, H), rand(19, B, R, F)
    ref = jdec.decode_step(p, w, h, f, theta)
    got = tdec.decode_step(carry(p), t(w), t(h), t(f), carry(theta))
    return jnp.concatenate(ref, axis=1), torch.cat(got, dim=1)


def case_hypernet_apply():
    hn = hypernet_params()
    e = rand(20, E)
    ref, got = jhn.hypernet_apply(hn, e), thn.hypernet_apply(carry(hn), t(e))
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    assert all(tuple(got[n].shape) == ref[n].shape for n in names)
    return (jnp.concatenate([ref[n].reshape(-1) for n in names]),
            torch.cat([got[n].reshape(-1) for n in names]))


def case_hypernet_apply_flat():
    hn = hypernet_params(M=500)
    e = rand(21, E)
    return jhn.hypernet_apply_flat(hn, e), thn.hypernet_apply_flat(carry(hn), t(e))


def case_synthesize_theta():
    model = {"decoder": decoder_params(), "hn": hypernet_params()}
    ref = jsteps.synthesize_theta(model, jnp.asarray(4, jnp.int32))
    got = tsteps.synthesize_theta(carry(model), 4)
    return (jnp.concatenate([ref[n].reshape(-1) for n in sorted(ref)]),
            torch.cat([got[n].reshape(-1) for n in sorted(got)]))


def case_synthesize_theta_dedicated_table():
    model = {"decoder": decoder_params(), "hn": hypernet_params(),
             "style_embed": jnp.asarray(rand(22, 3, E))}
    ref = jsteps.synthesize_theta(model, jnp.asarray(1, jnp.int32))
    got = tsteps.synthesize_theta(carry(model), 1)
    return (jnp.concatenate([ref[n].reshape(-1) for n in sorted(ref)]),
            torch.cat([got[n].reshape(-1) for n in sorted(got)]))


def case_synthesize_theta_batched():
    model = {"decoder": decoder_params(), "hn": hypernet_params()}
    ids = np.array([4, 3, 6])
    embeds = np.asarray(jsteps.style_table(model))[ids]
    ref = jsteps.synthesize_theta_batched(model, embeds)
    got = tsteps.synthesize_theta_batched(carry(model), t(embeds))
    assert all(tuple(got[n].shape) == ref[n].shape for n in ref)
    return (jnp.concatenate([ref[n].reshape(-1) for n in sorted(ref)]),
            torch.cat([got[n].reshape(-1) for n in sorted(got)]))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def test_style_names_match_captionax():
    from captionax.data.flickr import STYLE_NAMES as J_STYLE_NAMES
    from captionax_torch.data.flickr import STYLE_NAMES

    assert STYLE_NAMES == J_STYLE_NAMES


@pytest.mark.parametrize("dedicated", [False, True])
@pytest.mark.parametrize("style", ["factual", "humour", "romantic"])
def test_resolve_style_id(tiny_vocab, dedicated, style):
    """The id space follows the model: 0/1/2 with a dedicated table, the
    vocab id otherwise (``humour`` is ``<unk>`` there, as in the reference)."""
    model = {"decoder": decoder_params(), "hn": hypernet_params()}
    if dedicated:
        model["style_embed"] = jnp.asarray(rand(23, 3, E))
    ref = jsteps.resolve_style_id(model, tiny_vocab, style)
    got = tsteps.resolve_style_id(carry(model), tiny_vocab, style)
    assert got == ref and isinstance(got, int)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_captionax(name):
    ref, got = CASES[name]()
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("w_size,h,N,M", [
    (12, 16, 1, 500), (600, 200, 1, 500), (120000, 200, 1, 500),
    (240000, 200, 1, 500), (1536, 16, 1, 50), (48, 16, 2, 50),
])
def test_head_dims_and_sizes(w_size, h, N, M):
    assert thn._head_dims(w_size, h, N, M) == jhn._head_dims(w_size, h, N, M)
    assert thn.gru_tensor_sizes(400, 200) == jhn.gru_tensor_sizes(400, 200)
    assert thn.gru_tensor_sizes(32, 8, gates=4) == jhn.gru_tensor_sizes(32, 8, gates=4)


def test_theta_param_count():
    assert thn.theta_param_count(400, 200) == jhn.theta_param_count(400, 200) == 361200


def test_init_shapes_match_captionax():
    """Same keys and shapes from the port's seeded init as from captionax's."""
    g = torch.Generator().manual_seed(0)
    got = tdec.attention_gru_init(g, NF, F, E, H, V, num_layers=2, device="cpu")
    ref = np_tree(decoder_params(num_layers=2))
    gt = jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, got))
    assert gt == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, ref))
    flat_r = jax.tree_util.tree_leaves(ref)
    flat_t = jax.tree_util.tree_leaves(got)
    assert [x.shape for x in flat_r] == [tuple(x.shape) for x in flat_t]
    hn = thn.hypernet_init(g, E, E + F, H, device="cpu")
    hr = np_tree(hypernet_params(M=500))
    assert ([x.shape for x in jax.tree_util.tree_leaves(hr)]
            == [tuple(x.shape) for x in jax.tree_util.tree_leaves(hn)])
