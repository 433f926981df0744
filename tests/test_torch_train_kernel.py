"""K3 of the port (captionax_torch/ops/train_kernel.py) on the CPU, where
its wrappers run the plain versions, against captionax on the same weights
(carried with from_jax_params) and the same numpy inputs.

- the forward against captionax's fused_teacher_forced_hidden (Pallas, in
  interpret mode, as tests/test_train_kernel.py runs it) and against the
  lax.scan teacher_forced_hidden: rtol = atol = 1e-5, the tolerance of
  tests/test_train_kernel.py (f32 sums in another order);
- every gradient of the port's autograd path (the plain backward) against
  jax.grad of the scan, through the same asymmetric loss as
  tests/test_train_kernel.py: rtol 2e-4, atol max(2e-5 * scale, 1e-6), its
  tolerance (the floor covers d(v_a bias), exactly 0 here and ~1e-7 of
  float noise in the scan);
- the plain backward against torch.autograd of the plain forward, on the
  same tolerance (two f32 orders of the same sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captionax.models import decoder as jdec
from captionax.ops.train_kernel import fused_teacher_forced_hidden as j_fused
from captionax_torch.interop import from_jax_params
from captionax_torch.ops import _cuda
from captionax_torch.ops import train_kernel as tk
from captionax_torch.train.state import tree_leaves, tree_unflatten

torch.set_num_threads(1)
DIMS = dict(nf=32, f=16, e=16, h=16, v=128)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _make(seed=0, batch=12, regions=5, T=7):
    d = DIMS
    params = jax.tree_util.tree_map(np.asarray, jdec.attention_gru_init(
        jax.random.PRNGKey(seed), d["nf"], d["f"], d["e"], d["h"], d["v"]))
    rs = np.random.RandomState(seed + 100)
    feats = rs.randn(batch, regions, d["nf"]).astype(np.float32)
    caps = rs.randint(0, d["v"], (batch, T)).astype(np.int32)
    return params, feats, caps


def _theta(seed=9):
    d = DIMS
    return jax.tree_util.tree_map(np.asarray, jdec.attention_gru_init(
        jax.random.PRNGKey(seed), d["nf"], d["f"], d["e"], d["h"], d["v"])["gru"])


def _carry(tree):
    return from_jax_params(tree, device="cpu")


def _port_hs(params, feats, caps, theta=None):
    return tk.fused_teacher_forced_hidden(
        params, torch.as_tensor(feats), torch.from_numpy(caps), gru_params=theta)[0]


CASES = {
    "default": dict(),
    "theta_override": dict(theta=True),
    "odd_batch": dict(batch=11),
    "one_row": dict(batch=1),
    "49_regions": dict(regions=49, T=4),
}


def _case(name):
    kw = dict(CASES[name])
    use_theta = kw.pop("theta", False)
    params, feats, caps = _make(**kw)
    return params, feats, caps, (_theta() if use_theta else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_captionax_kernel(name):
    params, feats, caps, theta = _case(name)
    ref = j_fused(params, feats, caps, gru_params=theta, block_rows=8, bwd_block_rows=4,
                  interpret=True)[0]
    got = _port_hs(_carry(params), feats, caps, None if theta is None else _carry(theta))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_scan(name):
    params, feats, caps, theta = _case(name)
    ref = jdec.teacher_forced_hidden(params, feats, caps, gru_params=theta)[0]
    got = _port_hs(_carry(params), feats, caps, None if theta is None else _carry(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def _jax_loss(hs):
    """A CE-like reduction touching every hs element asymmetrically."""
    w = jnp.arange(hs.size, dtype=jnp.float32).reshape(hs.shape)
    return jnp.sum(jnp.tanh(hs) * w) / hs.size


def _torch_loss(hs):
    w = torch.arange(hs.numel(), dtype=torch.float32).reshape(hs.shape)
    return torch.sum(torch.tanh(hs) * w) / hs.numel()


def _assert_grad_close(got, ref, name):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=max(2e-5 * scale, 1e-6),
                               err_msg=f"grad mismatch at {name}")


@pytest.mark.parametrize("name", ["theta_override", "odd_batch", "one_row", "49_regions"])
def test_gradients_match_scan(name):
    params, feats, caps, theta = _case(name)
    theta = params["gru"] if theta is None else theta

    def jloss(p, th, f):
        return _jax_loss(jdec.teacher_forced_hidden(p, f, caps, gru_params=th)[0])

    ref = jax.grad(jloss, argnums=(0, 1, 2))(params, theta, feats)
    tree = {"p": _carry(params), "th": _carry(theta), "f": torch.from_numpy(feats)}
    leaves = [x.requires_grad_(True) for x in tree_leaves(tree)]
    tt = tree_unflatten(tree, leaves)
    hs = _port_hs(tt["p"], tt["f"], caps, tt["th"])
    grads = torch.autograd.grad(_torch_loss(hs), leaves, allow_unused=True)
    got = tree_unflatten(tree, [np.zeros(tuple(x.shape), np.float32) if gx is None
                                else gx.numpy() for x, gx in zip(leaves, grads)])
    refs = {"p": ref[0], "th": ref[1], "f": ref[2]}
    flat_ref = jax.tree_util.tree_flatten_with_path(refs)[0]
    flat_got = tree_leaves(got)
    assert len(flat_ref) == len(flat_got)
    for (path, a), b in zip(flat_ref, flat_got):
        _assert_grad_close(b, a, jax.tree_util.keystr(path))


def _core_inputs(name):
    """The eleven inputs of the recurrence for a case, in f32."""
    params, feats, caps, theta = _case(name)
    return [x.detach() for x in tk.core_inputs(
        _carry(params), torch.from_numpy(feats), torch.from_numpy(caps),
        None if theta is None else _carry(theta))]


@pytest.mark.parametrize("name", ["theta_override", "odd_batch", "one_row"])
def test_plain_backward_matches_autograd_of_plain_forward(name):
    args = [x.detach().clone().requires_grad_(True) for x in _core_inputs(name)]
    hs = tk.fused_fwd_plain(*args)
    g = torch.from_numpy(np.random.RandomState(5).randn(*hs.shape).astype(np.float32))
    ref = torch.autograd.grad(hs, args, g)
    got = tk.fused_bwd_plain(*[x.detach() for x in args], hs.detach(), g)
    names = ("feats", "att1", "h0", "embeds", "ua_w", "ua_b", "va", "wih_t", "whh_t",
             "bih", "bhh")
    for n, a, b in zip(names, ref, got):
        assert b.dtype == a.dtype and b.shape == a.shape, n
        _assert_grad_close(b.numpy(), a.numpy(), n)


def test_backward_passes_compose():
    """fused_bwd_plain is pass 1 then pass 2: the weight gradients of pass
    2's layout, summed over chunks of rows, equal the sums written out."""
    args = _core_inputs("odd_batch")
    hs = tk.fused_fwd_plain(*args)
    g = torch.from_numpy(np.random.RandomState(6).randn(*hs.shape).astype(np.float32))
    *_, rows, dva_part = tk.bwd_recurrence_plain(*args, hs, g)
    B, T, H = hs.shape
    In = args[7].shape[0]
    assert rows["x"].shape == (T * B, In) and rows["dgi"].shape == (T * B, 3 * H)
    assert dva_part.shape == (-(-B // tk.ROWS_PER_CTA), H)  # one partial per 8 rows
    partial = tk.wgrad_partial(rows)  # the CPU wrapper: the plain version
    assert partial.shape == (tk.WGRAD_SPLITS, tk.wgrad_layout(In, H)["total"][0])
    out, d_va = tk.wgrad_reduce(partial, torch.cat([dva_part[:1], 2 * dva_part[:1]]))
    np.testing.assert_allclose(d_va.numpy(), 3 * dva_part[0].numpy(), rtol=1e-6)
    d_wih, d_bih, d_whh, d_bhh, d_ua_w, d_ua_b = tk._split_wgrads(out, In, H)
    x, dgi, hp = rows["x"], rows["dgi"], rows["hp"]
    dgh = torch.cat([dgi[:, :2 * H], rows["dghn"]], dim=1)
    for got, ref in ((d_wih, x.t() @ dgi), (d_bih, dgi.sum(0)), (d_whh, hp.t() @ dgh),
                     (d_bhh, dgh.sum(0)), (d_ua_w, hp.t() @ rows["datt2"]),
                     (d_ua_b, rows["datt2"].sum(0))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    # the row of step t and batch row b is n = t*B + b: h_{t-1} of row b
    np.testing.assert_array_equal(hp[B:2 * B].numpy(), hs[:, 0].numpy())
    np.testing.assert_array_equal(hp[:B].numpy(), args[2].numpy())


def test_bf16_forward_rounds_like_the_jax_kernel():
    """In bf16 the plain forward keeps the JAX kernel's rounding points:
    against captionax's kernel (interpret mode) on bf16 inputs, the hidden
    states agree to 2e-2 (a few bf16 ulps: sums are taken in other orders,
    and a rounding that flips once is carried through 7 steps)."""
    params, feats, caps = _make()
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    ref = j_fused(jp, jnp.asarray(feats, jnp.bfloat16), caps, block_rows=8,
                  bwd_block_rows=4, interpret=True)[0]
    tp = from_jax_params(params, device="cpu", dtype=torch.bfloat16)
    got = tk.fused_teacher_forced_hidden(tp, torch.from_numpy(feats).to(torch.bfloat16),
                                         torch.from_numpy(caps))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_cpu_tensors_never_reach_a_kernel():
    for op in tk.KERNELS:
        op.launches = 0
    params, feats, caps, theta = _case("odd_batch")
    p = _carry(params)
    for x in tree_leaves(p):
        x.requires_grad_(True)
    hs = _port_hs(p, feats, caps)
    hs.sum().backward()
    assert all(op.launches == 0 for op in tk.KERNELS)
    assert _cuda._LIB is None


@pytest.mark.parametrize("which", ["fwd", "bwd", "wgrad_partial", "wgrad_reduce"])
def test_wrappers_raise_off_cpu_and_cuda(which):
    args = [x.to("meta") for x in _core_inputs("odd_batch")]
    B, T = args[3].shape[:2]
    H, In = args[2].shape[1], args[7].shape[0]
    hs = torch.empty((B, T, H), device="meta")
    rows = {k: torch.empty((T * B, w), device="meta")
            for k, w in (("x", In), ("dgi", 3 * H), ("hp", H), ("dghn", H), ("datt2", H))}
    calls = {
        "fwd": lambda: tk.fused_fwd(*args),
        "bwd": lambda: tk.fused_bwd(*args, hs, hs),
        "wgrad_partial": lambda: tk.wgrad_partial(rows),
        "wgrad_reduce": lambda: tk.wgrad_reduce(torch.empty((2, 9), device="meta"),
                                                torch.empty((3, H), device="meta")),
    }
    with pytest.raises(ValueError, match="no kernel"):
        calls[which]()


@pytest.mark.parametrize("n", [1, 15, tk.WGRAD_SPLITS - 1, tk.WGRAD_SPLITS, 16 * 16 + 1, 25 * 1024])
def test_wgrad_chunks_partition_the_rows(n):
    """The plain pass 2a cuts the rows as the kernel does: WGRAD_SPLITS
    consecutive chunks of ceil(n / splits) rows that cover 0..n once, the
    last ones empty when n is below the split count."""
    chunks = tk._chunks(n, tk.WGRAD_SPLITS)
    assert len(chunks) == tk.WGRAD_SPLITS
    per = -(-n // tk.WGRAD_SPLITS)
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    for (a, b), (c, _) in zip(chunks, chunks[1:]):
        assert b == c and 0 <= b - a <= per


def test_wgrad_partial_plain_with_empty_chunks():
    """Fewer rows than chunks: the chunks past the rows hold zeros, and the
    chunks' sum is the whole product."""
    rng = np.random.RandomState(3)
    n, In, H = 5, 8, 4
    rows = {k: torch.from_numpy(rng.randn(n, w).astype(np.float32))
            for k, w in (("x", In), ("dgi", 3 * H), ("hp", H), ("dghn", H), ("datt2", H))}
    partial = tk.wgrad_partial_plain(rows)
    assert partial.shape == (tk.WGRAD_SPLITS, tk.wgrad_layout(In, H)["total"][0])
    assert not partial[n:].any()
    np.testing.assert_allclose(partial.sum(0).numpy(), tk.wgrad_plain(rows).numpy(),
                               rtol=1e-5, atol=1e-6)
