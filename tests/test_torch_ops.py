"""The PyTorch port's ops against the JAX package, on the CPU: the plain
versions of the four CUDA kernels (two forward, two backward) against the
JAX Pallas kernels (interpret mode, set by tests/conftest.py) and their
VJPs, the segment ops and LayerNorm against their JAX counterparts, and
torch.autograd.gradcheck of the two differentiable ops in f64. Inputs are
numpy arrays from a seed; f32 on both sides, atol 1e-5 (rtol 1e-5): the two
differ only in summation order. Parameter gradients of the message-passing
backward sum over every edge of the batch: atol 1e-4 (rtol 1e-5)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.ops import attention as jattn  # noqa: E402
from dostransformer_tpu.ops import fused_mp as jmp  # noqa: E402
from dostransformer_tpu.ops import segment as jseg  # noqa: E402
from dostransformer_tpu_torch.nn.layernorm import layer_norm  # noqa: E402
from dostransformer_tpu_torch.ops import attention, fused_mp, segment  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _mp_inputs(seed=0, b=3, a=13, e=70, m=48, h=24):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(b, e) > 0.2).astype(np.float32)
    mask[-1] = 0.0  # a dummy graph: every edge is padding
    return dict(
        src_proj=f(b, a, m), dst_proj=f(b, a, m), edge_proj=f(b, e, m),
        senders=rng.randint(0, a, (b, e)).astype(np.int32),
        receivers=rng.randint(0, a, (b, e)).astype(np.int32),
        edge_mask=mask, ln_scale=(rng.rand(m) + 0.5).astype(np.float32),
        ln_bias=f(m) * 0.1, alpha=np.array([0.25], np.float32),
        w1=f(m, h) * 0.2, b1=f(h) * 0.1)


def _torch_mp_args(x):
    args = {k: torch.from_numpy(v) for k, v in x.items()}
    args["w1"] = args["w1"].T.contiguous()  # torch Linear layout [H, M]
    return args


@pytest.mark.parametrize("seed", [0, 1])
def test_mp_edge_reference_matches_jax_fused_kernel(seed):
    x = _mp_inputs(seed)
    want_e, want_agg = jmp.fused_mp_edge(**{k: jnp.asarray(v)
                                            for k, v in x.items()})
    got_e, got_agg = fused_mp.mp_edge_reference(**_torch_mp_args(x))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_agg.numpy(), np.asarray(want_agg), **TOL)


def test_fused_mp_edge_on_cpu_is_the_plain_version():
    x = _torch_mp_args(_mp_inputs(2))
    before = fused_mp.fused_mp_edge.launches
    got = fused_mp.fused_mp_edge(**x)
    want = fused_mp.mp_edge_reference(**x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fused_mp.fused_mp_edge.launches == before  # no kernel ran


def test_mp_edge_bwd_reference_matches_jax_vjp():
    """Against jax.vjp of the JAX fused_mp_edge, whose backward is the
    Pallas _bwd_kernel; nonzero cotangents on every edge, pad edges and the
    dummy graph's included."""
    x = _mp_inputs(3)
    b, e = x["senders"].shape
    a, h = x["src_proj"].shape[1], x["w1"].shape[1]
    rng = np.random.RandomState(4)
    g_eout = rng.randn(b, e, h).astype(np.float32)
    g_agg = rng.randn(b, a, h).astype(np.float32)
    names = ("src_proj", "dst_proj", "edge_proj", "ln_scale", "ln_bias",
             "alpha", "w1", "b1")

    def f(*diff):
        kw = {k: jnp.asarray(v) for k, v in x.items()}
        kw.update(zip(names, diff))
        return jmp.fused_mp_edge(**kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in names))
    want = vjp((jnp.asarray(g_eout), jnp.asarray(g_agg)))
    t = _torch_mp_args(x)
    t.pop("b1")
    got = fused_mp.mp_edge_bwd_reference(**t, g_eout=torch.from_numpy(g_eout),
                                         g_agg=torch.from_numpy(g_agg))
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "w1":
            w = w.T  # the port's [H, M] layout
        tol = TOL if name in ("src_proj", "dst_proj", "edge_proj") else dict(
            rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **tol)


def test_fused_mp_edge_gradcheck_f64():
    """The autograd.Function is differentiable on the CPU: its backward
    (mp_edge_bwd_reference) against finite differences, f64."""
    x = _torch_mp_args(_mp_inputs(5, b=2, a=5, e=9, m=8, h=4))
    args = [v.double().requires_grad_() if v.is_floating_point()
            and k != "edge_mask" else (v.double() if k == "edge_mask" else v)
            for k, v in x.items()]
    before = fused_mp.fused_mp_edge_bwd.launches
    assert torch.autograd.gradcheck(fused_mp.fused_mp_edge, args)
    assert fused_mp.fused_mp_edge_bwd.launches == before  # no kernel ran


def _attn_inputs(seed, b, lq, lk, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, n, d).astype(np.float32) for n in (lq, lk, lk))
    mask = rng.rand(b, lk) > 0.3
    mask[:, 0] = True
    mask[-1] = False  # a fully masked row: a dummy graph of a short batch
    return q, k, v, mask


@pytest.mark.parametrize("shape", [(3, 9, 5, 32), (2, 17, 17, 64)])
@pytest.mark.parametrize("masked", [True, False])
def test_dot_product_attention_matches_jax_fused_kernel(shape, masked):
    q, k, v, mask = _attn_inputs(3, *shape)
    km = mask if masked else None
    want = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 None if km is None else jnp.asarray(km))
    got = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if km is None else torch.from_numpy(km))
    real = slice(None, -1) if masked else slice(None)
    np.testing.assert_allclose(got[real].numpy(), np.asarray(want)[real],
                               **TOL)
    if masked:
        # all keys masked -> the uniform average of v over the real keys,
        # not NaN, as JAX's plain path gives it. (The Pallas kernel's padded
        # form also averages in its zero lane-padding keys; in the model a
        # fully masked row belongs to a dummy graph, whose v is all zero.)
        want_plain = jattn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km))
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_plain)[-1],
                                   **TOL)
        np.testing.assert_allclose(got[-1].numpy(),
                                   np.broadcast_to(v[-1].mean(0), got[-1].shape),
                                   **TOL)


def test_fused_attention_on_cpu_is_the_plain_version():
    q, k, v, mask = (torch.from_numpy(t) for t in _attn_inputs(4, 2, 7, 6, 32))
    before = attention.fused_attention.launches
    torch.testing.assert_close(attention.fused_attention(q, k, v, mask),
                               attention.dot_product_attention(q, k, v, mask),
                               rtol=0, atol=0)
    assert attention.fused_attention.launches == before


def _jax_attention_grads(q, k, v, mask, g):
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn._fused_attention(
        q, k, v, jnp.asarray(bias)), *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))], bias


@pytest.mark.parametrize("nopad", ["0", "1"], ids=["padded", "nopad"])
@pytest.mark.parametrize("shape", [(3, 9, 5, 32), (2, 17, 17, 64)])
def test_attention_bwd_reference_matches_jax_pallas_bwd(shape, nopad,
                                                         monkeypatch):
    """Against the JAX Pallas backward kernel (forced on), in its padded and
    no-pad forms, on partly masked rows; the no-pad form also on a fully
    masked row (the padded form averages such a row over its 128
    lane-padded keys instead)."""
    monkeypatch.setenv("DOSTPU_ATTN_PALLAS_BWD", "1")
    monkeypatch.setenv("DOSTPU_ATTN_NOPAD", nopad)
    q, k, v, mask = _attn_inputs(6, *shape)
    if nopad == "0":
        mask[-1, 0] = True  # every row keeps a key
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    want, bias = _jax_attention_grads(q, k, v, mask, g)
    got = attention.attention_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v, bias, g)))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), w, err_msg=name, **TOL)


def test_fused_attention_backward_on_cpu_is_the_plain_version():
    q, k, v, mask = (torch.from_numpy(t) for t in _attn_inputs(8, 2, 7, 6, 32))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = attention.fused_attention_bwd.launches
    got = torch.autograd.grad(attention.fused_attention(*leaves, mask), leaves,
                              g)
    want = attention.attention_bwd_reference(q, k, v,
                                             attention.key_bias(mask), g)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, rtol=0, atol=0)
    assert attention.fused_attention_bwd.launches == before


def test_fused_attention_gradcheck_f64():
    """The autograd.Function is differentiable on the CPU, f64, with k and v
    one tensor as in the model. The softmax runs at exactly f32 by contract,
    so finite differences carry ~6e-8 / eps of rounding noise: eps 1e-2,
    atol 1e-4. Rows keep at least one key (a fully masked row's forward is
    flat in floating point; its gradient is pinned against JAX above)."""
    q, kv, _, mask = _attn_inputs(9, 2, 5, 6, 32)
    mask[:, 0] = True
    km = torch.from_numpy(mask)
    q, kv = (torch.from_numpy(t).double().requires_grad_() for t in (q, kv))
    assert torch.autograd.gradcheck(
        lambda q, kv: attention.fused_attention(q, kv, kv, km), (q, kv),
        eps=1e-2, atol=1e-4, rtol=1e-3)


def test_segment_ops_match_jax():
    rng = np.random.RandomState(5)
    data = rng.randn(3, 20, 4).astype(np.float32)
    ids = rng.randint(-1, 9, (3, 20)).astype(np.int32)  # -1, 8: dropped
    w = (rng.rand(3, 20) > 0.3).astype(np.float32)
    data = data * w[..., None]
    want_sum = jseg.batched_segment_sum(jnp.asarray(data), jnp.asarray(ids), 8)
    got_sum = segment.batched_segment_sum(torch.from_numpy(data),
                                          torch.from_numpy(ids), 8)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), **TOL)
    want_mean = jseg.batched_segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                          8, jnp.asarray(w))
    got_mean = segment.batched_segment_mean(torch.from_numpy(data),
                                            torch.from_numpy(ids), 8,
                                            torch.from_numpy(w))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), **TOL)


def test_layer_norm_matches_flax():
    from flax import linen as fnn

    rng = np.random.RandomState(6)
    x = (rng.randn(2, 5, 16) * 3 + 1).astype(np.float32)
    scale = (rng.rand(16) + 0.5).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    want = fnn.LayerNorm(epsilon=1e-5, dtype=None).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert layer_norm(torch.from_numpy(x).double(), torch.from_numpy(scale),
                      torch.from_numpy(bias)).dtype == torch.float64
