"""The port's data-parallel serving on the CPU: ``make_sharded_beam_decode``
and ``CaptionService(mesh=...)`` over one-process meshes of CPU slots.

The sharded beam decode is held to captionax's (its fused kernel in
interpret mode under ``shard_map`` on a 2- and a 4-device CPU mesh) on
weights carried by ``from_jax_params``, f32: tokens, lengths and found
flags exact (tests/test_serving.py), scores within 1e-5.  The sharded
service is held to the port's one-device service row for row, and to
captionax's sharded service on the pattern of tests/test_service.py (its
captions equal, its scores within 1e-3: the two encoders' bf16 roundings
differ, tests/test_torch_service.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.decode import serving as jserving
from captionax.decode.service import CaptionService as JCaptionService
from captionax.models import decoder as jdec
from captionax.models.hypernet import hypernet_init as j_hypernet_init
from captionax.parallel.mesh import make_mesh as jmake_mesh
from captionax_torch.core.vocab import SPECIAL_TOKENS, STYLE_TOKENS, Vocab
from captionax_torch.decode import serving as tserving
from captionax_torch.decode.service import CaptionService
from captionax_torch.interop import from_jax_params
from captionax_torch.parallel import make_mesh
from test_torch_conv_kernel import captionax_resnet, randomize_bn

torch.set_num_threads(1)
NF, F, E, H, V, R = 24, 12, 12, 12, 37, 9
B, STEPS = 16, 8
SCORE_TOL = 1e-5
SERVICE_SCORE_TOL = 1e-3
STYLES = ["factual", "humorous", "romantic"]
WORDS = "a dog runs in the grass after ball cat sits on mat sun chasing his dreams love".split()


def theta_bank(key, n=3):
    thetas = [jdec.attention_gru_init(k, NF, F, E, H, V)["gru"] for k in jax.random.split(key, n)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *thetas)


@pytest.fixture(scope="module")
def model():
    params = jdec.attention_gru_init(jax.random.PRNGKey(5), NF, F, E, H, V)
    params["fc"]["b"] = params["fc"]["b"].at[2].add(0.4)
    feats = jax.random.normal(jax.random.PRNGKey(7), (B, R, NF))
    rows = jnp.asarray(np.arange(B) % 3, jnp.int32)
    return params, theta_bank(jax.random.PRNGKey(6)), feats, rows


def carry(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("bank", (False, True), ids=("one_theta", "bank"))
def test_sharded_beam_matches_captionax(model, n, bank):
    params, thetas, feats, rows = model
    kw = dict(max_steps=STEPS, block_images=2, f32=True)
    ref_decode = jserving.make_sharded_beam_decode(
        jmake_mesh(n_data=n), params, gru_params=thetas if bank else None, interpret=True, **kw)
    ref = ref_decode(feats, rows) if bank else ref_decode(feats)
    decode = tserving.make_sharded_beam_decode(
        make_mesh(devices=["cpu"] * n), carry(params),
        gru_params=carry(thetas) if bank else None, **kw)
    got = decode(np.array(feats), np.array(rows) if bank else None)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=0,
                               atol=SCORE_TOL)


def test_sharded_beam_packed_through_the_pipelined_decoder(model):
    params, thetas, feats, rows = model
    mesh = make_mesh(devices=["cpu", "cpu"])
    kw = dict(gru_params=carry(thetas), max_steps=STEPS, f32=True)
    want = tserving.make_sharded_beam_decode(mesh, carry(params), **kw)(np.array(feats),
                                                                         np.array(rows))
    stream = tserving.PipelinedDecoder(
        tserving.make_sharded_beam_decode(mesh, carry(params), packed=True, **kw))
    got = tserving.unpack_beam_result(next(iter(stream.map([(np.array(feats),
                                                             np.array(rows))]))))
    np.testing.assert_array_equal(got.tokens, want.tokens.numpy())
    np.testing.assert_array_equal(got.scores, want.scores.numpy())


def test_sharded_beam_needs_a_dividing_batch(model):
    params, thetas, feats, rows = model
    decode = tserving.make_sharded_beam_decode(make_mesh(devices=["cpu"] * 4), carry(params),
                                               gru_params=carry(thetas), max_steps=STEPS)
    with pytest.raises(ValueError, match="divide"):
        decode(np.array(feats)[:15], np.array(rows)[:15])
    with pytest.raises(ValueError, match="style_rows"):
        decode(np.array(feats))


# ------------------------------------------------------------ the service
SVC_BATCH, SVC_STEPS, SVC_F = 4, 5, 16


@pytest.fixture(scope="module")
def service_weights():
    vocab = Vocab()
    for word in SPECIAL_TOKENS + STYLE_TOKENS + tuple(WORDS):
        vocab.add_word(word)
    k = jax.random.split(jax.random.PRNGKey(0), 2)
    params = {"decoder": jdec.attention_gru_init(k[0], 2048, SVC_F, SVC_F, SVC_F, len(vocab)),
              "hn": j_hypernet_init(k[1], hyper_emb=SVC_F, input_dim=2 * SVC_F,
                                    hidden_dim=SVC_F)}
    images = np.random.RandomState(3).randint(0, 256, (SVC_BATCH, 224, 224, 3)).astype(np.uint8)
    return vocab, params, randomize_bn(captionax_resnet(50), seed=11), images


def port_service(weights, mesh=None, **kw):
    vocab, params, enc, _ = weights
    return CaptionService(carry(params), carry(enc), vocab, STYLES, batch_size=SVC_BATCH,
                          max_steps=SVC_STEPS, use_fused=False, mesh=mesh, device="cpu", **kw)


def dispatched(svc, images, rows):
    """One whole dispatch of the service's micro-batcher -> numpy rows."""
    return np.asarray(svc._batcher.decode_fn(images, rows))


ROWS = np.asarray([1, 0, 2, 1], np.int32)


@pytest.mark.parametrize("decode", ("beam", "greedy"))
def test_mesh_service_matches_one_device(service_weights, decode):
    images = service_weights[3]
    with port_service(service_weights, decode=decode) as one, \
            port_service(service_weights, mesh=make_mesh(devices=["cpu", "cpu"]),
                         decode=decode) as two:
        want, got = dispatched(one, images, ROWS), dispatched(two, images, ROWS)
        if decode == "beam":
            want, got = tserving.unpack_beam_result(want), tserving.unpack_beam_result(got)
            np.testing.assert_array_equal(got.tokens, want.tokens)
            np.testing.assert_array_equal(got.found, want.found)
            np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=SCORE_TOL)
        else:
            np.testing.assert_array_equal(got, want)
        single = two.caption_array(images[0], "romantic")
        assert single == one.caption_array(images[0], "romantic")


def test_mesh_service_matches_captionax(service_weights):
    vocab, params, enc, images = service_weights
    kw = dict(styles=STYLES, batch_size=SVC_BATCH, max_steps=SVC_STEPS, use_fused=False)
    with JCaptionService(params, enc, vocab, mesh=jmake_mesh(n_data=2), **kw) as ref_svc:
        ref = tserving.unpack_beam_result(dispatched(ref_svc, images, ROWS))
    with port_service(service_weights, mesh=make_mesh(devices=["cpu", "cpu"])) as svc:
        got = tserving.unpack_beam_result(dispatched(svc, images, ROWS))
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.found, ref.found)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=SERVICE_SCORE_TOL)


def test_mesh_service_batch_size_must_divide(service_weights):
    with pytest.raises(ValueError, match="divide"):
        port_service(service_weights, mesh=make_mesh(devices=["cpu"] * 3))
