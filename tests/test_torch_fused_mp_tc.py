"""The arithmetic of the tensor-core form of the port's fused message-passing
kernels, emulated in plain torch on the CPU.

The CUDA kernels (csrc/fused_mp.cu ``edge_tc_kernel``, csrc/fused_mp_bwd.cu
``edge_bwd_tc_kernel`` and ``gw1_tc_kernel``) treat the B*E edges as one flat
list and form each of the three products as three TF32 tensor-core products
of the operands' split ``x = hi + lo`` (each cut to 10 mantissa bits, lo
from the exact remainder), accumulated in f32 per staged chunk (64 columns
of W1 in the forward, 32 rows of W1 for ``g_e @ W1``, 64 edges for
``g_e^T act``) and the chunks
added in order; ``g_W1`` is a split-K product whose per-split partials, like
the per-block partials of the other parameter gradients, are summed in a
fixed order. This file repeats that arithmetic with torch ops and holds it
against the plain versions (``mp_edge_reference``,
``mp_edge_bwd_reference``) and against the JAX package's ``fused_mp_edge``
and its VJP (Pallas kernels in interpret mode, as tests/test_fused_mp.py
runs them), at the E and A of the two flagships with M and H cut to 64 and
32, a ragged E, a batch of one, a dummy graph (every edge padding) and an
index out of range.

Tolerance, as for the kernels on the card: max abs error <= 1e-5 x
max(1, max|want|) for tensors, 1e-4 x for the five parameter gradients
(sums over every edge of the batch). A single TF32 pass does not hold it at
K = 512, which is why the kernels split. The file also pins which widths
take which form.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.ops import fused_mp as jmp  # noqa: E402
from dostransformer_tpu_torch.ops import fused_mp  # noqa: E402

RTOL, PARAM_RTOL = 1e-5, 1e-4
# (B, A, E, M, H): eDOS and phDOS flagship A and E, phDOS at batch 1, ragged
SHAPES = [(3, 32, 384, 64, 32), (3, 16, 128, 64, 32), (1, 16, 128, 64, 32),
          (3, 13, 70, 64, 32), (2, 7, 45, 96, 160)]
IDS = ["edos", "phdos", "phdos-b1", "ragged-70", "ragged-45"]
NAMES = ("src_proj", "dst_proj", "edge_proj", "ln_scale", "ln_bias", "alpha",
         "w1", "b1")


def split_tf32(x):
    """x -> (hi, lo) as the tensor core reads the kernels' split: hi is x cut
    to 10 mantissa bits, lo = x - hi (exact in f32) cut the same way (the
    tensor core ignores an operand's low 13 bits)."""
    def cut(t):
        bits = t.contiguous().view(torch.int32)
        return (bits & ~0x1FFF).view(torch.float32)
    hi = cut(x)
    return hi, cut(x - hi)


def matmul_3x(a, b):
    """a @ b as one chunk of the kernels forms it: the two small cross terms,
    then the large one."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_1x(a, b):
    return split_tf32(a)[0] @ split_tf32(b)[0]


def chunked(product, a, b, step):
    """a [n, K] @ b [K, m] over K in chunks of ``step``, added in order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], step):
        acc = acc + product(a[:, k0:k0 + step], b[k0:k0 + step])
    return acc


def flat_rows(x, idx, a):
    """x [B, A, F] gathered by idx [B, E] into [B*E, F]; an index outside
    [0, A) reads a zero row."""
    b, e = idx.shape
    ok = (idx >= 0) & (idx < a)
    rows = x[torch.arange(b)[:, None], idx.clamp(0, a - 1).long()]
    return (rows * ok[..., None]).reshape(b * e, -1)


def scatter_rows(rows, idx, a):
    """rows [B*E, F] summed onto idx [B, E] -> [B, A, F], edge by edge in
    order; an index outside [0, A) reaches no node."""
    b, e = idx.shape
    out = torch.zeros(b, a + 1, rows.shape[-1])
    to = torch.where((idx >= 0) & (idx < a), idx, a).long()
    out.index_put_((torch.arange(b)[:, None].expand(b, e), to),
                   rows.reshape(b, e, -1), accumulate=True)
    return out[:, :a]


def recompute(sp, dp, ep, senders, receivers, ln_scale, ln_bias, alpha):
    a = sp.shape[1]
    mid = ((flat_rows(sp, senders, a) + flat_rows(dp, receivers, a))
           + ep.reshape(-1, ep.shape[-1]))
    mean = mid.mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(((mid - mean) ** 2).mean(-1, keepdim=True)
                            + fused_mp.LN_EPS)
    xhat = (mid - mean) * rstd
    norm = xhat * ln_scale + ln_bias
    act = torch.where(norm > 0, norm, alpha * norm)
    return xhat, rstd, norm, act


def emulated_forward(sp, dp, ep, senders, receivers, mask, ln_scale, ln_bias,
                     alpha, w1, b1, product=matmul_3x):
    b, e = senders.shape
    a, h = sp.shape[1], w1.shape[0]
    _, _, _, act = recompute(sp, dp, ep, senders, receivers, ln_scale,
                             ln_bias, alpha)
    e_out = chunked(product, act, w1.T, 64) + b1
    agg = scatter_rows(e_out * mask.reshape(-1, 1), receivers, a)
    return e_out.reshape(b, e, h), agg


def emulated_backward(sp, dp, ep, senders, receivers, mask, ln_scale,
                      ln_bias, alpha, w1, g_eout, g_agg, block_edges=32,
                      split_edges=128):
    """The four passes: per-edge gradients, g_W1 as a split-K product over
    ``split_edges`` edges a partial in 64-edge chunks, the scatter, and the
    partials of the parameter gradients (one per ``block_edges`` edges)
    summed in block order."""
    b, e = senders.shape
    a, m = sp.shape[1], sp.shape[2]
    n = b * e
    xhat, rstd, norm, act = recompute(sp, dp, ep, senders, receivers,
                                      ln_scale, ln_bias, alpha)
    g_e = (g_eout.reshape(n, -1)
           + mask.reshape(n, 1) * flat_rows(g_agg, receivers, a))
    g_act = chunked(matmul_3x, g_e, w1, 32)
    pos = norm > 0
    g_norm = torch.where(pos, g_act, alpha * g_act)
    gx = g_norm * ln_scale
    g_mid = rstd * (gx - gx.mean(-1, keepdim=True)
                    - xhat * (gx * xhat).mean(-1, keepdim=True))

    def by_block(rows):  # per-block partial sums, added in block order
        total = torch.zeros(rows.shape[1:])
        for n0 in range(0, n, block_edges):
            total = total + rows[n0:n0 + block_edges].sum(0)
        return total

    g_w1 = torch.zeros_like(w1)
    for s0 in range(0, n, split_edges):
        part = chunked(matmul_3x, g_e[s0:s0 + split_edges].T,
                       act[s0:s0 + split_edges], 64)
        g_w1 = g_w1 + part
    g_alpha = by_block(torch.where(pos, 0.0, g_act * norm).sum(-1,
                                                              keepdim=True))
    return (scatter_rows(g_mid, senders, a), scatter_rows(g_mid, receivers, a),
            g_mid.reshape(b, e, m), by_block(g_norm * xhat), by_block(g_norm),
            g_alpha, g_w1, by_block(g_e))


def inputs(shape, seed=0, bad_index=False):
    """numpy arrays from a seed; the last graph of a batch is a dummy (every
    edge padding) when there is more than one graph."""
    b, a, e, m, h = shape
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mask = (rng.rand(b, e) > 0.2).astype(np.float32)
    if b > 1:
        mask[-1] = 0.0
    x = dict(
        src_proj=f(b, a, m), dst_proj=f(b, a, m), edge_proj=f(b, e, m),
        senders=rng.randint(0, a, (b, e)).astype(np.int32),
        receivers=rng.randint(0, a, (b, e)).astype(np.int32),
        edge_mask=mask, ln_scale=(rng.rand(m) + 0.5).astype(np.float32),
        ln_bias=f(m) * 0.1, alpha=np.array([0.25], np.float32),
        w1=f(m, h) * m ** -0.5, b1=f(h) * 0.1)
    if bad_index:
        x["senders"][0, 0] = a + 5   # reads a zero row
        x["receivers"][0, 3] = -1    # reads a zero row, reaches no node
    return x


def torch_args(x):
    args = {k: torch.from_numpy(v) for k, v in x.items()}
    args["w1"] = args["w1"].T.contiguous()  # torch Linear layout [H, M]
    return args


def plain_with_bad_indices(fn, t, *cot):
    """The plain version where an out-of-range index reads a zero row and
    reaches no node: an extra zero node takes it, and is cut off again."""
    a = t["src_proj"].shape[1]
    pad = lambda v: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
    fix = lambda i: torch.where((i < 0) | (i >= a), a, i)
    t = dict(t, src_proj=pad(t["src_proj"]), dst_proj=pad(t["dst_proj"]),
             senders=fix(t["senders"]), receivers=fix(t["receivers"]))
    if not cot:
        e_out, agg = fn(**t)
        return e_out, agg[:, :a]
    out = list(fn(**t, g_eout=cot[0], g_agg=pad(cot[1])))
    out[0], out[1] = out[0][:, :a], out[1][:, :a]
    return tuple(out)


def cotangents(shape, seed=7):
    b, a, e, _, h = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, e, h).astype(np.float32),
            rng.randn(b, a, h).astype(np.float32))


def assert_close(got, want, what, rtol=RTOL):
    assert got.shape == want.shape, what
    err = (got - want).abs().max().item()
    limit = rtol * max(1.0, want.abs().max().item())
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


def test_a_single_tf32_pass_misses_the_tolerance_at_k_512():
    rng = np.random.RandomState(0)
    act = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(256, 512).astype(np.float32) * 512 ** -0.5)
    want = (act.double() @ w1.double().T).float()
    limit = RTOL * max(1.0, want.abs().max().item())
    one = chunked(matmul_1x, act, w1.T, 64)
    three = chunked(matmul_3x, act, w1.T, 64)
    assert (one - want).abs().max().item() > limit
    assert (three - want).abs().max().item() <= limit


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_forward_matches_the_plain_version(shape):
    t = torch_args(inputs(shape))
    got = emulated_forward(*t.values())
    want = fused_mp.mp_edge_reference(**t)
    for name, g, w in zip(("e_out", "agg"), got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, name)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_emulated_forward_matches_the_jax_kernel(shape):
    x = inputs(shape, seed=1)
    want = jmp.fused_mp_edge(**{k: jnp.asarray(v) for k, v in x.items()})
    got = emulated_forward(*torch_args(x).values())
    for name, g, w in zip(("e_out", "agg"), got, want):
        assert_close(g, torch.from_numpy(np.array(w)), name)


def test_emulated_forward_with_an_index_out_of_range():
    t = torch_args(inputs((3, 13, 70, 64, 32), seed=2, bad_index=True))
    got = emulated_forward(*t.values())
    want = plain_with_bad_indices(fused_mp.mp_edge_reference, t)
    for name, g, w in zip(("e_out", "agg"), got, want):
        assert_close(g, w, name)


@pytest.mark.parametrize("block_edges", [16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulated_backward_matches_the_plain_version(shape, block_edges):
    t = torch_args(inputs(shape, seed=3))
    t.pop("b1")
    cot = tuple(map(torch.from_numpy, cotangents(shape)))
    got = emulated_backward(*t.values(), *cot, block_edges=block_edges,
                            split_edges=64 if block_edges == 16 else 128)
    want = fused_mp.mp_edge_bwd_reference(**t, g_eout=cot[0], g_agg=cot[1])
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        assert_close(g, w, name, RTOL if i < 3 else PARAM_RTOL)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=IDS[:4])
def test_emulated_backward_matches_the_jax_vjp(shape):
    x = inputs(shape, seed=4)
    g_eout, g_agg = cotangents(shape)

    def f(*diff):
        kw = {k: jnp.asarray(v) for k, v in x.items()}
        kw.update(zip(NAMES, diff))
        return jmp.fused_mp_edge(**kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in NAMES))
    want = vjp((jnp.asarray(g_eout), jnp.asarray(g_agg)))
    t = torch_args(x)
    t.pop("b1")
    got = emulated_backward(*t.values(), torch.from_numpy(g_eout),
                            torch.from_numpy(g_agg))
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        w = np.array(w)
        if name == "w1":
            w = np.ascontiguousarray(w.T)  # the port's [H, M] layout
        assert_close(g, torch.from_numpy(w), name,
                     RTOL if i < 3 else PARAM_RTOL)


def test_emulated_backward_with_an_index_out_of_range():
    shape = (3, 13, 70, 64, 32)
    t = torch_args(inputs(shape, seed=5, bad_index=True))
    t.pop("b1")
    cot = tuple(map(torch.from_numpy, cotangents(shape)))
    got = emulated_backward(*t.values(), *cot)
    want = plain_with_bad_indices(fused_mp.mp_edge_bwd_reference, t, *cot)
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        assert_close(g, w, name, RTOL if i < 3 else PARAM_RTOL)


def seq_matmul(a, b):
    """a [n, K] @ b [K, m] with one product added at a time in K order: the
    order of the generic forms' FMA loops (a single running sum per output
    across the staged chunks)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def emulated_generic_forward(sp, dp, ep, senders, receivers, mask, ln_scale,
                             ln_bias, alpha, w1, b1):
    """csrc/fused_mp.cu edge_kernel: each row's statistics from mid, each
    32-column chunk of act formed anew from them (the same values as a kept
    row), e_out as one running sum over M; agg as the forward's agg."""
    b, e = senders.shape
    a, h = sp.shape[1], w1.shape[0]
    _, _, _, act = recompute(sp, dp, ep, senders, receivers, ln_scale,
                             ln_bias, alpha)
    e_out = seq_matmul(act, w1.T) + b1
    agg = scatter_rows(e_out * mask.reshape(-1, 1), receivers, a)
    return e_out.reshape(b, e, h), agg


def emulated_generic_backward(sp, dp, ep, senders, receivers, mask, ln_scale,
                              ln_bias, alpha, w1, g_eout, g_agg):
    """csrc/fused_mp_bwd.cu, generic form: pass A per (graph, 16 edges):
    g_act = g_e @ W1 as one running sum over H (g_e in [16 x 32] chunks
    beside W1's), PReLU and LayerNorm backward per row, the block's partial
    sums of the LN, b1 and alpha gradients; the partials added in block
    order (graph-major); g_W1 as split-K partials of at most 768 edges
    (one running sum over the edges of a split), added in split order."""
    b, e = senders.shape
    a, m = sp.shape[1], sp.shape[2]
    n = b * e
    xhat, rstd, norm, act = recompute(sp, dp, ep, senders, receivers,
                                      ln_scale, ln_bias, alpha)
    g_e = (g_eout.reshape(n, -1)
           + mask.reshape(n, 1) * flat_rows(g_agg, receivers, a))
    g_act = seq_matmul(g_e, w1)
    pos = norm > 0
    g_norm = torch.where(pos, g_act, alpha * g_act)
    gx = g_norm * ln_scale
    g_mid = rstd * (gx - gx.mean(-1, keepdim=True)
                    - xhat * (gx * xhat).mean(-1, keepdim=True))
    blocks = [(g * e + e0, g * e + min(e, e0 + 16))
              for g in range(b) for e0 in range(0, e, 16)]

    def by_block(rows):
        total = torch.zeros(rows.shape[1:])
        for lo, hi in blocks:
            total = total + rows[lo:hi].sum(0)
        return total

    splits = min(64, max(1, -(-n // 768)))
    chunk = -(-n // splits)
    g_w1 = torch.zeros_like(w1)
    for s0 in range(0, n, chunk):
        g_w1 = g_w1 + seq_matmul(g_e[s0:s0 + chunk].T, act[s0:s0 + chunk])
    g_alpha = by_block(torch.where(pos, 0.0, g_act * norm).sum(-1,
                                                              keepdim=True))
    return (scatter_rows(g_mid, senders, a), scatter_rows(g_mid, receivers, a),
            g_mid.reshape(b, e, m), by_block(g_norm * xhat), by_block(g_norm),
            g_alpha, g_w1, by_block(g_e))


# the generic forms' shapes: widths no multiple of 32 (a hidden of 25 and
# of 21), a ragged E, a batch of one
GENERIC_SHAPES = [(3, 13, 70, 50, 25), (1, 16, 128, 42, 21),
                  (2, 7, 45, 64, 32)]


@pytest.mark.parametrize("shape", GENERIC_SHAPES,
                         ids=["h25-ragged", "h21-b1", "h32-ragged"])
def test_emulated_generic_forms_match_the_plain_version(shape):
    """The generic forms' running sums (their shared memory no longer holds
    a row of M or H) against the plain versions: 1e-5 tensors, 1e-4 the
    parameter gradients."""
    t = torch_args(inputs(shape, seed=8))
    got = emulated_generic_forward(*t.values())
    want = fused_mp.mp_edge_reference(**t)
    for name, g, w in zip(("e_out", "agg"), got, want):
        assert_close(g, w, name)
    t.pop("b1")
    cot = tuple(map(torch.from_numpy, cotangents(shape)))
    got = emulated_generic_backward(*t.values(), *cot)
    want = fused_mp.mp_edge_bwd_reference(**t, g_eout=cot[0], g_agg=cot[1])
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        assert_close(g, w, name, RTOL if i < 3 else PARAM_RTOL)


def test_emulated_generic_backward_with_an_index_out_of_range():
    shape = (3, 13, 70, 50, 25)
    t = torch_args(inputs(shape, seed=5, bad_index=True))
    t.pop("b1")
    cot = tuple(map(torch.from_numpy, cotangents(shape)))
    got = emulated_generic_backward(*t.values(), *cot)
    want = plain_with_bad_indices(fused_mp.mp_edge_bwd_reference, t, *cot)
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        assert_close(g, w, name, RTOL if i < 3 else PARAM_RTOL)


# widths -> the forward's form, the backward's: multiples of 32 take the
# tensor cores where a block fits in shared memory (the forward up to
# M = 3,072; the backward's block keeps xhat and g_act of its own M / cluster
# columns, so at H = M / 2 every such width up to 1,024 and beyond, in a
# cluster of 2 or 4 from M = 1,088), every other width the FMA kernels,
# whose blocks take the same shared memory at every width
@pytest.mark.parametrize("widths, forward, backward", [
    ((512, 256), "tc", "tc"), ((64, 32), "tc", "tc"), ((96, 160), "tc", "tc"),
    ((32, 32), "tc", "tc"), ((1024, 512), "tc", "tc"),
    ((1088, 544), "tc", "tc"), ((1152, 576), "tc", "tc"),
    ((1216, 608), "tc", "tc"), ((2048, 1024), "tc", "tc"),
    ((1536, 64), "tc", "tc"), ((3072, 32), "tc", "tc"),
    ((3104, 32), "generic", "generic"), ((48, 24), "generic", "generic"),
    ((600, 300), "generic", "generic"), ((32, 16), "generic", "generic"),
    ((520, 256), "generic", "generic"), ((512, 24), "generic", "generic"),
    ((0, 32), "generic", "generic"), ((1248, 624), "generic", "generic"),
    ((1536, 768), "tc", "tc"), ((2000, 1000), "generic", "generic"),
    ((1280, 640), "tc", "tc"), ((2080, 1040), "generic", "generic"),
    ((2100, 1050), "generic", "generic"), ((4096, 2048), "generic", "generic"),
    ((4160, 2080), "generic", "generic"), ((3136, 1568), "generic", "generic"),
    ((8192, 4096), "generic", "generic")])
def test_which_widths_take_which_form(widths, forward, backward):
    code = {"tc": fused_mp.FORM_TENSOR_CORE, "generic": fused_mp.FORM_GENERIC}
    assert fused_mp.fused_mp_form(*widths) == code[forward]
    assert fused_mp.fused_mp_bwd_form(*widths) == code[backward]


# the backward's shared memory a block, as csrc/fused_mp_bwd.cu's comments
# state it: the tensor-core pass A at M = 512, H = 256 (32 edges, 2 staged
# tiles; 16 edges, 4) and at M = 2,048, H = 1,024 (16 edges by a cluster of
# 4, 4 tiles; one block keeping every column, 2 tiles: fits no block); the
# generic pass A at both widths
@pytest.mark.parametrize("form, widths, shape, want", [
    ("tc", (512, 256), (2, 1, 2), 232064), ("tc", (512, 256), (1, 1, 4), 217408),
    ("tc", (2048, 1024), (1, 4, 4), 201024),
    ("tc", (2048, 1024), (1, 1, 2), 395584),
    ("generic", (512, 256), None, 35040),
    ("generic", (2048, 1024), None, 35040)])
def test_backward_shared_memory_mirrors(form, widths, shape, want):
    """The generic pass A keeps no row of M or H floats: 35,040 B at every
    width (csrc/fused_mp_bwd.cu)."""
    if form == "tc":
        assert fused_mp.bwd_tc_smem_bytes(*widths, *shape) == want
    else:
        assert fused_mp.bwd_generic_smem_bytes() == want


def test_forward_generic_shared_memory_mirror():
    """The forward's generic block: 36,032 B at every width
    (csrc/fused_mp.cu)."""
    assert fused_mp.fwd_generic_smem_bytes() == 36032


def test_every_hidden_width_up_to_1024_has_a_backward_form():
    """At M = 2H every H up to 1,040 fits a form (_check_smem refuses
    none); H = 1,040, no multiple of 32, takes the generic form, whose
    block no longer grows with the widths."""
    for h in range(1, 1041):
        m = 2 * h
        if fused_mp.fused_mp_bwd_form(m, h) == fused_mp.FORM_GENERIC:
            assert fused_mp.bwd_generic_smem_bytes() <= fused_mp.SMEM_MAX
    assert fused_mp.fused_mp_bwd_form(2080, 1040) == fused_mp.FORM_GENERIC


def _fwd_tc_fits(m):
    """The forward's smallest tensor-core tile: 16 rows of M + 4 floats and
    two staged [64 x 68] chunks of W1."""
    return 4 * (16 * (m + 4) + 2 * 64 * 68) <= fused_mp.SMEM_MAX


@pytest.mark.parametrize("hidden", [range(1, 701), range(701, 1401),
                                    range(1401, 2101), [4096]],
                         ids=["1-700", "701-1400", "1401-2100", "4096"])
def test_every_hidden_width_has_a_form_of_both_kernels_that_fits(hidden):
    """At M = 2H every hidden width has a form of the forward (#1) and of
    the backward (#2) whose block fits in shared memory, so _check_smem
    refuses none: the tensor-core forms where they fit, else the generic
    forms, the same size at every width."""
    for h in hidden:
        m = 2 * h
        if fused_mp.fused_mp_form(m, h) == fused_mp.FORM_TENSOR_CORE:
            assert _fwd_tc_fits(m), h
        else:
            assert fused_mp.fwd_generic_smem_bytes() <= fused_mp.SMEM_MAX
        if fused_mp.fused_mp_bwd_form(m, h) == fused_mp.FORM_TENSOR_CORE:
            assert any(fused_mp._bwd_tc_shapes(m, h)), h
        else:
            assert fused_mp.bwd_generic_smem_bytes() <= fused_mp.SMEM_MAX
    # the widths the card tests take: 1,040 and 1,050 generic, 2,080 too
    # (a multiple of 32 whose tensor-core block fits in no cluster shape)
    for h in (1040, 1050, 2080):
        if h in hidden:
            assert fused_mp.fused_mp_bwd_form(2 * h, h) == fused_mp.FORM_GENERIC


def test_a_forced_form_is_checked():
    fused_mp._check_form("fused_mp_edge", fused_mp.FORM_TENSOR_CORE, 512, 256)
    with pytest.raises(ValueError, match="multiples of 32"):
        fused_mp._check_form("fused_mp_edge", fused_mp.FORM_TENSOR_CORE, 48,
                             24)
    fused_mp._check_form("fused_mp_edge", fused_mp.FORM_GENERIC, 48, 24)
    fused_mp._check_form("fused_mp_edge", fused_mp.FORM_BY_SHAPE, 48, 24)
    for form in (2, 100, 141):
        with pytest.raises(ValueError, match="none of FORM_BY_SHAPE"):
            fused_mp._check_form("fused_mp_edge", form, 512, 256)
