"""The port's serving front end on the CPU: the packed result layout round
trips, and the beam and greedy servers, the pipelined stream and the
micro-batcher give exactly what a direct call gives (same code path, so
tolerance: none)."""

import threading

import numpy as np
import pytest
import torch

from captionax_torch.decode.search import BeamResult
from captionax_torch.decode.serving import (
    MicroBatcher,
    PipelinedDecoder,
    fetch,
    make_beam_server,
    make_greedy_server,
    pack_beam_result,
    unpack_beam_result,
)
from captionax_torch.models.decoder import attention_gru_init
from captionax_torch.models.hypernet import hypernet_init
from captionax_torch.ops.decode_kernel import fused_beam_search, fused_greedy
from captionax_torch.train.steps import synthesize_theta, synthesize_theta_batched

torch.set_num_threads(1)
NF, F, E, H, V, R, STEPS = 32, 16, 16, 16, 120, 5, 8


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    dec = attention_gru_init(g, NF, F, E, H, V, device="cpu")
    dec["fc"]["b"][2] += 1.0
    hn = hypernet_init(g, E, E + F, H, device="cpu")
    return {"decoder": dec, "hn": hn}


def feats(seed, n):
    return np.random.RandomState(seed).randn(n, R, NF).astype(np.float32)


def equal(got, ref):
    """Field-by-field equality of two BeamResults of numpy arrays."""
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)


def test_pack_unpack_round_trip():
    res = BeamResult(
        torch.tensor([[0, 5, 2, 0], [0, 7, 8, 2]], dtype=torch.int32),
        torch.tensor([-1.25, -1e9]),
        torch.tensor([True, False]),
        torch.tensor([3, 0], dtype=torch.int32),
    )
    packed = pack_beam_result(res)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, 7)
    back = unpack_beam_result(packed.numpy())
    for a, b in zip(back, res):
        np.testing.assert_array_equal(a, b.numpy())
    assert back.scores.dtype == np.float32 and back.found.dtype == bool


@pytest.mark.parametrize("packed", [False, True])
def test_beam_server_equals_direct_call(model, packed):
    theta = synthesize_theta(model, 4)
    srv = make_beam_server(model["decoder"], theta, max_steps=STEPS, packed=packed, f32=True,
                           device="cpu")
    batches = [feats(1, 3), feats(2, 3), feats(3, 3)]
    outs = list(srv.map(batches))
    assert len(outs) == 3
    for f, out in zip(batches, outs):
        ref = fused_beam_search(model["decoder"], torch.from_numpy(f), gru_params=theta,
                                max_steps=STEPS, f32=True, device="cpu")
        got = unpack_beam_result(out) if packed else out
        equal(got, fetch(ref))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_beam_server_rejects_other_beam_widths(model, k):
    with pytest.raises(ValueError):
        make_beam_server(model["decoder"], synthesize_theta(model, 4), k=k, device="cpu")


def test_mixed_style_server(model):
    bank = synthesize_theta_batched(model, model["decoder"]["embed"][[4, 3, 6]])
    srv = make_beam_server(model["decoder"], bank, max_steps=STEPS, packed=True, f32=True,
                           device="cpu")
    rows = np.array([0, 2, 1, 7], np.int32)
    f = feats(4, 4)
    (out,) = list(srv.map([(f, rows)]))
    ref = fused_beam_search(model["decoder"], torch.from_numpy(f), gru_params=bank,
                            max_steps=STEPS, f32=True, style_rows=torch.from_numpy(rows),
                            device="cpu")
    equal(unpack_beam_result(out), fetch(ref))


def test_pipelined_decoder_keeps_order():
    calls = []

    def decode(x):
        calls.append(int(x))
        return torch.tensor([int(x)])

    got = [int(r[0]) for r in PipelinedDecoder(decode, depth=2).map(range(5))]
    assert got == [0, 1, 2, 3, 4] and calls == got


def test_micro_batcher_equals_direct_call(model):
    theta = synthesize_theta(model, 4)
    srv = make_beam_server(model["decoder"], theta, max_steps=STEPS, packed=True, f32=True,
                           device="cpu")
    n = 6
    f = feats(5, n)
    direct = fetch(srv.decode_fn(f))
    answers = [None] * n
    with MicroBatcher(srv.decode_fn, batch_size=n, feature_shape=(R, NF)) as mb:
        def ask(i):
            answers[i] = mb.submit(f[i]).result(timeout=120)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        bad = mb.submit(np.zeros((R + 1, NF), np.float32))
        with pytest.raises(ValueError):
            bad.result(timeout=120)
        again = mb.submit(f[0]).result(timeout=120)  # the worker survived
    for i in range(n):
        np.testing.assert_array_equal(answers[i], direct[i])
    np.testing.assert_array_equal(again, direct[0])


def test_greedy_server_equals_direct_call(model):
    theta = synthesize_theta(model, 4)
    srv = make_greedy_server(model["decoder"], theta, max_len=STEPS, f32=True, device="cpu")
    batches = [feats(1, 3), feats(2, 3), feats(3, 3)]
    outs = list(srv.map(batches))
    assert len(outs) == 3
    for f, out in zip(batches, outs):
        ref = fused_greedy(model["decoder"], torch.from_numpy(f), gru_params=theta,
                           max_len=STEPS, f32=True, device="cpu")
        assert out.dtype == np.int32 and out.shape == (3, STEPS)
        np.testing.assert_array_equal(out, ref.numpy())


def test_mixed_style_greedy_server(model):
    bank = synthesize_theta_batched(model, model["decoder"]["embed"][[4, 3, 6]])
    srv = make_greedy_server(model["decoder"], bank, max_len=STEPS, f32=True, device="cpu")
    rows = np.array([0, 2, 1, 7], np.int32)
    f = feats(4, 4)
    (out,) = list(srv.map([(f, rows)]))
    ref = fused_greedy(model["decoder"], torch.from_numpy(f), gru_params=bank,
                       max_len=STEPS, f32=True, style_rows=torch.from_numpy(rows),
                       device="cpu")
    np.testing.assert_array_equal(out, ref.numpy())
    with pytest.raises(ValueError, match="style_rows"):
        list(srv.map([f]))


def test_micro_batcher_with_the_greedy_server(model):
    srv = make_greedy_server(model["decoder"], synthesize_theta(model, 4), max_len=STEPS,
                             f32=True, device="cpu")
    n = 5
    f = feats(6, n)
    direct = fetch(srv.decode_fn(f))
    answers = [None] * n
    with MicroBatcher(srv.decode_fn, batch_size=n, feature_shape=(R, NF)) as mb:
        def ask(i):
            answers[i] = mb.submit(f[i]).result(timeout=120)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    for i in range(n):
        np.testing.assert_array_equal(answers[i], direct[i])
