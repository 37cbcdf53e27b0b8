"""The arithmetic of the port's tensor-core attention kernels, emulated in
plain torch on the CPU.

The CUDA kernels (csrc/attention.cu, csrc/attention_bwd.cu) form every
product as three TF32 tensor-core products of the operands' split
``x = hi + lo`` (hi and lo rounded to nearest at 10 mantissa bits),
accumulated in f32, run the softmax online over tiles of 32 keys, and the
backward takes the forward's row max m and row sum l. This file repeats
that arithmetic with torch ops and holds it against the plain versions
(``dot_product_attention``, ``attention_bwd_reference``) and against the JAX
package's ``fused_attention`` and its VJP, at the Lq x Lk of the six
attention calls of the two flagships (D cut to 64, batch cut to 3 or 4) and
at ragged shapes, the last graph of each batch fully masked.

Tolerance, as for the kernels on the card: max abs error <= 1e-5 x
max(1, max|want|). A single TF32 pass does not hold it, which is why the
kernels split.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu_torch.ops import attention  # noqa: E402

RTOL = 1e-5
TILE = 32
# (B, Lq, Lk, D): cross, self, source of eDOS (201 bins, 32 atom slots) and
# of phDOS (51 bins, 16 atom slots), then ragged shapes
SHAPES = [(3, 201, 32, 64), (4, 201, 201, 64), (4, 201, 32, 64),
          (3, 51, 16, 64), (4, 51, 51, 64), (4, 51, 16, 64),
          (3, 13, 5, 64), (2, 1, 1, 32)]
IDS = ["edos-cross", "edos-self", "edos-source", "phdos-cross", "phdos-self",
       "phdos-source", "13x5", "1x1"]


def split_tf32(x):
    """x -> (hi, lo): hi = x rounded to nearest (ties away from zero, as
    ``cvt.rna.tf32.f32``) at 10 mantissa bits, lo = x - hi rounded the same
    way."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def matmul_3x(a, b):
    """a @ b as the kernels form it: the two small cross terms, then the
    large one, each an exact-operand product accumulated in f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulated_forward(q, k, v, bias, product=matmul_3x):
    """Online softmax over key tiles of 32 -> (out, stats [2, B, Lq])."""
    b, lq, d = q.shape
    scale = d ** -0.5
    m = torch.full((b, lq), -float("inf"))
    l = torch.zeros(b, lq)
    o = torch.zeros(b, lq, d)
    for k0 in range(0, k.shape[1], TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = product(q, kt.transpose(1, 2)) * scale + bias[:, None, k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + product(p, vt)
        m = m_new
    return o / l[..., None], torch.stack([m, l])


def emulated_backward(q, k, v, bias, o, g, stats):
    """(dq, dk, dv) from the forward's statistics, five split products."""
    scale = q.shape[-1] ** -0.5
    s = matmul_3x(q, k.transpose(1, 2)) * scale + bias[:, None, :]
    p = torch.exp(s - stats[0][..., None]) * (1.0 / stats[1])[..., None]
    dp = matmul_3x(g, v.transpose(1, 2))
    ds = p * (dp - (g * o).sum(-1, keepdim=True))
    return (matmul_3x(ds, k) * scale, matmul_3x(ds.transpose(1, 2), q) * scale,
            matmul_3x(p.transpose(1, 2), g))


def inputs(shape, seed=0):
    """q, k, v, g from a seed with numpy; pad keys masked, the last graph
    fully masked (a dummy graph of a short batch)."""
    b, lq, lk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b, n, d).astype(np.float32))
                  for n in (lq, lk, lk, lq))
    mask = np.arange(lk)[None] < rng.randint(1, lk + 1, (b, 1))
    mask[-1] = False
    mask = torch.from_numpy(mask)
    return q, k, v, g, mask, attention.key_bias(mask)


def assert_close(got, want, what):
    err = (got - want).abs().max().item()
    limit = RTOL * max(1.0, want.abs().max().item())
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


def test_split_tf32_keeps_ten_bits_and_the_rest():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32) * 37.0)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - (hi + lo)).abs() <= x.abs() * 2.0 ** -21).all()
    # ties round away from zero, for either sign
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert split_tf32(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                           -(1.0 + 2.0 ** -10)]


def test_a_single_tf32_pass_does_not_hold_the_contract():
    q, k, v, _, mask, bias = inputs((3, 51, 51, 64), seed=1)
    want = attention.dot_product_attention(q, k, v, mask)
    one_pass = lambda a, b: split_tf32(a)[0] @ split_tf32(b)[0]
    got, _ = emulated_forward(q, k, v, bias, product=one_pass)
    err = (got - want).abs().max().item()
    assert err > RTOL * max(1.0, want.abs().max().item())
    assert_close(emulated_forward(q, k, v, bias)[0], want, "3xTF32 forward")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_forward_matches_the_plain_version(shape):
    q, k, v, _, mask, bias = inputs(shape)
    got, stats = emulated_forward(q, k, v, bias)
    assert torch.isfinite(got).all()
    assert_close(got, attention.dot_product_attention(q, k, v, mask), "out")
    want = attention.attention_stats_reference(q, k, bias)
    # the fully masked graph: every score exactly -1e30, p = 1, l = Lk
    assert (stats[0][-1] == attention.NEG_INF).all()
    assert (stats[1][-1] == shape[2]).all()
    assert (want[0][-1] == attention.NEG_INF).all()
    assert (want[1][-1] == shape[2]).all()
    assert_close(stats[0][:-1], want[0][:-1], "row max")
    # m may sit on another key tile's maximum by a rounding: compare m + log l
    assert_close(stats[0][:-1] + stats[1][:-1].log(),
                 want[0][:-1] + want[1][:-1].log(), "log-sum-exp")
    # keys and values as one tensor, as the transformer layer passes them
    assert_close(emulated_forward(q, k, k, bias)[0],
                 attention.dot_product_attention(q, k, k, mask), "out, v is k")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_backward_matches_the_plain_version(shape):
    q, k, v, g, mask, bias = inputs(shape, seed=2)
    o, stats = emulated_forward(q, k, v, bias)
    got = emulated_backward(q, k, v, bias, o, g, stats)
    want = attention.attention_bwd_reference(q, k, v, bias, g)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(x).all()
        assert_close(x, w, name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_reference_with_the_forward_stats_equals_itself_without(shape):
    q, k, v, g, _, bias = inputs(shape, seed=3)
    stats = attention.attention_stats_reference(q, k, bias)
    assert stats.shape == (2, shape[0], shape[1])
    with_stats = attention.attention_bwd_reference(q, k, v, bias, g, stats)
    without = attention.attention_bwd_reference(q, k, v, bias, g)
    for name, x, w in zip(("dq", "dk", "dv"), with_stats, without):
        assert_close(x, w, name)
    # and the emulated forward's statistics serve as well
    emulated = emulated_forward(q, k, v, bias)[1]
    for name, x, w in zip(("dq", "dk", "dv"),
                          attention.attention_bwd_reference(q, k, v, bias, g,
                                                            emulated),
                          without):
        assert_close(x, w, f"{name} from the emulated stats")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_kernels_match_the_jax_package(shape):
    """Forward against the JAX package's ``fused_attention`` (its Pallas
    kernel in interpret mode) and backward against its VJP, on the graphs
    that keep a key: the Pallas kernel's padded form averages a fully masked
    row over its lane padding too, which no model output ever reads."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dostransformer_tpu.ops import attention as jattn

    q, k, v, g, mask, bias = inputs(shape, seed=4)
    jq, jk, jv, jg, jbias = (jnp.asarray(t.numpy()) for t in (q, k, v, g, bias))
    want, vjp = jax.vjp(lambda a, b, c: jattn._fused_attention(a, b, c, jbias),
                        jq, jk, jv)
    o, stats = emulated_forward(q, k, v, bias)
    real = slice(None, -1)
    assert_close(o[real], torch.from_numpy(np.array(want))[real], "out")
    # a zero upstream gradient on the dummy graph, as the loss mask gives it
    jg = jg.at[-1].set(0.0)
    g = g.clone()
    g[-1] = 0.0
    got = emulated_backward(q, k, v, bias, o, g, stats)
    for name, x, w in zip(("dq", "dk", "dv"), got, vjp(jg)):
        assert_close(x[real], torch.from_numpy(np.array(w))[real], name)
