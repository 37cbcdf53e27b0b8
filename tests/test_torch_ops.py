"""The PyTorch port's ops against the JAX package, on the CPU: the plain
versions of the two CUDA kernels against the JAX Pallas kernels (interpret
mode, set by tests/conftest.py) and the segment ops and LayerNorm against
their JAX counterparts. Inputs are numpy arrays from a seed; f32 on both
sides, atol 1e-5 (rtol 1e-5): the two differ only in summation order."""

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
