"""The arithmetic of the attention kernels' rows form, emulated in plain
torch on the CPU.

The rows form (csrc/attention_rows.cuh; attn_fwd_rows_kernel in
csrc/attention.cu, dq_rows_kernel and dkv_rows_kernel in
csrc/attention_bwd.cu) takes bf16 operands at every width and f32 operands
above D = 512, up to 256 keys (``attention_plan``). A block of 16 rows
forms its rows' scores ONCE over the full D: the operands' columns stream
in chunks (64 for bf16, 32 for f32) in column order, each n8 tile of 8
keys an independent accumulator; bf16 products are exact and summed in
f32, f32 products are 3xTF32. It then takes the exact row max and sum of
the held rows (no online rescaling), keeps p (bf16: normalised and rounded
to bf16 before p v, where the TPU kernel rounds it) and multiplies by the
values slice by slice of output columns, in tiles of 32 (bf16) or 16 (f32)
keys. The backward holds s and dp: delta = rowsum(dp p32) comes from the
held rows in the same pass, ds is rounded before its products, each
output once after its scale; dk and dv come from query chunks of at most
256 queries whose f32 partials are added in chunk order.

This file repeats that arithmetic with torch ops, row sums in the kernel's
order (a thread's n8 tiles, then the row's four lanes, then the four
warps), and holds it against the plain versions (``dot_product_attention``,
``attention_bwd_reference``) and against the JAX package's
``fused_attention`` and its VJP (the Pallas kernels in interpret mode), at
the Lq x Lk of the six attention calls of the two flagships with the batch
cut to 2-4 and the last graph fully masked.

Tolerances, as for the kernels on the card: f32 max abs error <= 1e-5 x
max(1, max|want|); bf16 2^-7 x max(1, max|want|) (one bf16 rounding of an
f32 result each side); the row statistics in f32 within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu_torch.ops import attention  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
RTOL = {torch.float32: F32_RTOL, torch.bfloat16: BF16_RTOL}
CHUNK = {torch.float32: 32, torch.bfloat16: 64}  # rows::Op<T>::kChunk
TILE_ROWS = {torch.float32: 16, torch.bfloat16: 32}  # rows::Op<T>::kTileRows
MAX_L = 256  # rows::kMaxL
WARPS, LANES_A_ROW = 4, 4
# (B, Lq, Lk): cross, self, source of eDOS (201 bins, 32 atom slots) and of
# phDOS (51 bins, 16 atom slots), the batch cut to 2-4
CALLS = {"edos-cross": (2, 201, 32), "edos-self": (4, 201, 201),
         "edos-source": (4, 201, 32), "phdos-cross": (2, 51, 16),
         "phdos-self": (4, 51, 51), "phdos-source": (4, 51, 16)}
# (dtype, D) of the rows form on the main paths: bf16 at h256 and h1024,
# f32 at h1024
FORMS = [(torch.bfloat16, 256), (torch.bfloat16, 1024),
         (torch.float32, 1024)]
FORM_IDS = ["bf16-d256", "bf16-d1024", "f32-d1024"]
# every (call, dtype, D) of those that the plan gives the rows form
ROWS_CALLS = [pytest.param(call, dtype, d, id=f"{call}-{fid}")
              for (dtype, d), fid in zip(FORMS, FORM_IDS) for call in CALLS
              if attention.attention_plan(d, CALLS[call][2], dtype).form
              == attention.FORM_ROWS]


def split_tf32(x):
    """x -> (hi, lo), each rounded to nearest at TF32's 10 mantissa bits
    (ties away from zero, as the kernels' round_tf32)."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def product(a, b, dtype):
    """a @ b as the tensor cores form it: bf16 values multiplied exactly and
    summed in f32; f32 values as 3xTF32 (the small terms first)."""
    a, b = a.float(), b.float()
    if dtype == torch.bfloat16:
        return a @ b
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def held_scores(a, t, dtype):
    """a [B, R, D] . t [B, L, D]^T as phase 1 forms it: each n8 tile of t's
    rows its own accumulator, the column chunks added in column order."""
    d = a.shape[-1]
    c = CHUNK[dtype]
    tiles = []
    for j0 in range(0, t.shape[1], 8):
        acc = 0.0
        for c0 in range(0, d, c):
            acc = acc + product(a[..., c0:c0 + c],
                                t[:, j0:j0 + 8, c0:c0 + c].transpose(1, 2),
                                dtype)
        tiles.append(acc)
    return torch.cat(tiles, -1)


def kernel_row_sum(x):
    """Row sums of x [B, R, L] (L <= 256) in the kernels' order: a thread
    (warp w, lane t) adds its columns 32 i + 8 w + 2 t (+1) for i
    ascending; the row's four lanes add as (t0 + t1) + (t2 + t3); the warps
    as ((w0 + w1) + w2) + w3."""
    b, r, lk = x.shape
    pad = torch.zeros(b, r, MAX_L)
    pad[..., :lk] = x
    parts = pad.view(b, r, MAX_L // 32, WARPS, LANES_A_ROW, 2)
    acc = torch.zeros(b, r, WARPS, LANES_A_ROW)
    for i in range(MAX_L // 32):
        for e in range(2):
            acc = acc + parts[..., i, :, :, e]
    lanes = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    return ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) + lanes[..., 3]


def held_softmax(s):
    """The exact softmax statistics of the held biased scores: (p =
    exp(s - m), m, l)."""
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return p, m, kernel_row_sum(p)


def sliced_product(held, u, dtype, scale=None):
    """held [B, R, L] . u [B, L, D] as phase 3 forms it: slices of 32 nc
    output columns (f32: 512), u's rows in tiles, added in tile order; each
    row times its scale ([B, R] or a number)."""
    d = u.shape[-1]
    width = (attention.SLICE_COLUMNS if dtype == torch.float32
             else 32 * attention.attention_plan(d, 1, dtype).nc)
    rows = TILE_ROWS[dtype]
    out = torch.zeros(held.shape[0], held.shape[1], d)
    for s0 in range(0, d, width):
        acc = 0.0
        for k0 in range(0, u.shape[1], rows):
            acc = acc + product(held[..., k0:k0 + rows],
                                u[:, k0:k0 + rows, s0:s0 + width], dtype)
        out[..., s0:s0 + width] = acc
    if scale is not None:
        out = out * (scale[..., None] if torch.is_tensor(scale) else scale)
    return out


def rounded(x, dtype):
    """x as the held operand keeps it: f32, or rounded to bf16."""
    return x.to(dtype).float()


def rows_forward(q, k, v, bias):
    """attn_fwd_rows_kernel -> (out in q's dtype, stats [2, B, Lq])."""
    dtype = q.dtype
    s = held_scores(q, k, dtype) * q.shape[-1] ** -0.5 + bias[:, None, :]
    p, m, l = held_softmax(s)
    if dtype == torch.bfloat16:  # normalised, then rounded, before p v
        out = sliced_product(rounded(p / l[..., None], dtype), v, dtype)
    else:
        out = sliced_product(p, v, dtype, 1.0 / l)
    return out.to(dtype), torch.stack([m, l])


def rows_dq(q, k, v, bias, g, stats=None):
    """dq_rows_kernel -> (dq, m, l, delta): without the forward's stats the
    forward's own softmax (held_softmax) recomputes them."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    s = held_scores(q, k, dtype) * scale + bias[:, None, :]
    dp = held_scores(g, v, dtype)
    if stats is None:
        p, m, l = held_softmax(s)
    else:
        m, l = stats
        p = torch.exp(s - m[..., None])
    p32 = p / l[..., None]
    delta = kernel_row_sum(p32 * dp)  # from the held rows: one pass
    ds = rounded(p32 * (dp - delta[..., None]), dtype)
    return sliced_product(ds, k, dtype, scale).to(dtype), m, l, delta


def rows_dkv(q, k, v, bias, g, m, l, delta, chunk_len):
    """dkv_rows_kernel over query chunks of chunk_len (<= 256): each
    chunk's f32 partial dk and dv, added in chunk order, rounded once."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    dk = dv = 0.0
    for i0 in range(0, q.shape[1], chunk_len):
        i1 = min(q.shape[1], i0 + chunk_len)
        st = held_scores(k, q[:, i0:i1], dtype) * scale + bias[..., None]
        dpt = held_scores(v, g[:, i0:i1], dtype)
        pt = torch.exp(st - m[:, None, i0:i1]) / l[:, None, i0:i1]
        dst = pt * (dpt - delta[:, None, i0:i1])
        dv = dv + sliced_product(rounded(pt, dtype), g[:, i0:i1], dtype)
        dk = dk + sliced_product(rounded(dst, dtype), q[:, i0:i1], dtype,
                                 scale)
    return dk.to(dtype), dv.to(dtype)


def rows_backward(q, k, v, bias, g, stats=None, chunk_len=MAX_L):
    dq, m, l, delta = rows_dq(q, k, v, bias, g, stats)
    return (dq, *rows_dkv(q, k, v, bias, g, m, l, delta, chunk_len))


def inputs(b, lq, lk, d, dtype, seed=0):
    """q, k, v, g from a seed with numpy, in dtype; pad keys masked, the
    last graph fully masked (a dummy graph of a short batch)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b, n, d).astype(
        np.float32)).to(dtype) for n in (lq, lk, lk, lq))
    mask = np.arange(lk)[None] < rng.randint(1, lk + 1, (b, 1))
    mask[-1] = False
    mask = torch.from_numpy(mask)
    return q, k, v, g, mask, attention.key_bias(mask)


def assert_close(got, want, rtol, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs().max().item()
    limit = rtol * max(1.0, want.abs().max().item())
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("call,dtype,d", ROWS_CALLS)
def test_rows_forward_matches_the_plain_version(call, dtype, d):
    b, lq, lk = CALLS[call]
    assert attention.attention_plan(d, lk, dtype).form == attention.FORM_ROWS
    q, k, v, _, mask, bias = inputs(b, lq, lk, d, dtype)
    got, stats = rows_forward(q, k, v, bias)
    assert got.dtype == dtype
    assert_close(got, attention.dot_product_attention(q, k, v, mask),
                 RTOL[dtype], "out")
    want = attention.attention_stats_reference(q, k, bias)
    # the fully masked graph: every score exactly -1e30, p = 1, l = Lk
    assert (stats[0][-1] == attention.NEG_INF).all()
    assert (stats[1][-1] == lk).all()
    assert_close(stats[0][:-1], want[0][:-1], F32_RTOL, "row max")
    assert_close(stats[0][:-1] + stats[1][:-1].log(),
                 want[0][:-1] + want[1][:-1].log(), F32_RTOL, "log-sum-exp")
    # keys and values as one tensor, as the transformer layer passes them,
    # are the same arithmetic as two copies
    one = rows_forward(q, k, k, bias)[0]
    assert torch.equal(one, rows_forward(q, k, k.clone(), bias)[0])
    assert_close(one, attention.dot_product_attention(q, k, k, mask),
                 RTOL[dtype], "out, v is k")


@pytest.mark.parametrize("call,dtype,d", ROWS_CALLS)
def test_rows_backward_matches_the_plain_version(call, dtype, d):
    b, lq, lk = CALLS[call]
    q, k, v, g, _, bias = inputs(b, lq, lk, d, dtype, seed=1)
    _, stats = rows_forward(q, k, v, bias)
    got = rows_backward(q, k, v, bias, g, stats)
    want = attention.attention_bwd_reference(q, k, v, bias, g)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype
        assert_close(x, w, RTOL[dtype], name)
    # without the forward's statistics the backward recomputes them with
    # the forward's own arithmetic: the same bits
    again = rows_backward(q, k, v, bias, g)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("call", ["edos-cross", "edos-self", "phdos-self"])
def test_one_pass_delta_equals_two_pass_delta(call):
    """delta = rowsum(dp p32) from the held rows (one pass over the keys)
    has the bits of the previous bf16 design's two passes (the first for
    delta, key tile by key tile, the second forming s and dp again) when
    the sums run in the same order: each n8 tile's s and dp are one
    accumulator's, whichever pass forms them."""
    b, lq, lk = CALLS[call]
    dtype = torch.bfloat16
    q, k, v, g, _, bias = inputs(b, lq, lk, 128, dtype, seed=2)
    scale = 128 ** -0.5
    _, stats = rows_forward(q, k, v, bias)
    m, l = stats
    one = rows_dq(q, k, v, bias, g, stats)[3]

    # pass 1 walks the 32-key tiles; every thread adds its tiles' terms in
    # the order kernel_row_sum adds them (tile i of 32 keys holds the
    # thread's i-th n8 tile)
    acc = torch.zeros(b, lq, WARPS, LANES_A_ROW)
    for i, k0 in enumerate(range(0, lk, 32)):
        kt, vt = k[:, k0:k0 + 32], v[:, k0:k0 + 32]
        s = held_scores(q, kt, dtype) * scale + bias[:, None, k0:k0 + 32]
        p32 = torch.exp(s - m[..., None]) / l[..., None]
        x = torch.zeros(b, lq, 32)
        x[..., :p32.shape[-1]] = p32 * held_scores(g, vt, dtype)
        parts = x.view(b, lq, WARPS, LANES_A_ROW, 2)
        for e in range(2):
            acc = acc + parts[..., e]
    lanes = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    two = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) + lanes[..., 3]
    assert torch.equal(one, two)
    # and both are the plain rowsum(dp * p) within f32 rounding
    s = held_scores(q, k, dtype) * scale + bias[:, None, :]
    p32 = torch.exp(s - m[..., None]) / l[..., None]
    want = (p32 * held_scores(g, v, dtype)).sum(-1)
    assert_close(one, want, F32_RTOL, "delta")


def test_kernel_row_sum_is_the_row_sum():
    rng = np.random.RandomState(5)
    for lk in (1, 7, 16, 33, 201, 256):
        x = torch.from_numpy(rng.rand(3, 5, lk).astype(np.float32))
        assert_close(kernel_row_sum(x), x.double().sum(-1).float(), 1e-6,
                     f"Lk={lk}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_query_chunks_of_dk_dv_add_up(dtype):
    """Past 256 queries dk and dv come from chunks of at most 256 queries
    (f32 partials added in chunk order, rounded once): against the plain
    backward, and against one chunk where one would do."""
    q, k, v, g, _, bias = inputs(2, 300, 29, 64, dtype, seed=3)
    _, stats = rows_forward(q, k, v, bias)
    want = attention.attention_bwd_reference(q, k, v, bias, g)
    for chunk_len in (96, 256):
        got = rows_backward(q, k, v, bias, g, stats, chunk_len)
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            assert_close(x, w, RTOL[dtype], f"{name}, chunks of {chunk_len}")


def test_a_tf32_pass_of_f32_operands_would_miss_the_contract():
    """Why the f32 rows form keeps 3xTF32: one TF32 pass of the scores
    misses 1e-5 at D = 1,024."""
    q, k, v, _, mask, bias = inputs(2, 51, 51, 1024, torch.float32, seed=4)
    one = lambda a, b: split_tf32(a)[0] @ split_tf32(b)[0]
    s = one(q, k.transpose(1, 2)) * 1024 ** -0.5 + bias[:, None, :]
    got = torch.softmax(s, -1) @ v
    want = attention.dot_product_attention(q, k, v, mask)
    err = (got - want).abs().max().item()
    assert err > F32_RTOL * max(1.0, want.abs().max().item())
    assert_close(rows_forward(q, k, v, bias)[0], want, F32_RTOL, "3xTF32")


@pytest.mark.parametrize("dtype,d", FORMS + [(torch.bfloat16, 64)],
                         ids=FORM_IDS + ["bf16-d64"])
@pytest.mark.parametrize("call", ["edos-cross", "phdos-self"])
def test_rows_form_matches_the_jax_package(call, dtype, d, monkeypatch):
    """Forward against the JAX package's ``fused_attention`` (its Pallas
    kernel in interpret mode) and backward against its VJP through the
    Pallas backward (``DOSTPU_ATTN_PALLAS_BWD=1``), on the graphs that keep
    a key: the Pallas kernel's padded form averages a fully masked row over
    its lane padding too, which no model output ever reads."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dostransformer_tpu.ops import attention as jattn

    monkeypatch.setenv("DOSTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DOSTPU_ATTN_PALLAS_BWD", "1")
    b, lq, lk = CALLS[call]
    q, k, v, g, mask, bias = inputs(b, lq, lk, d, dtype, seed=6)
    g[-1] = 0.0  # a zero upstream gradient on the dummy graph
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jdt)
                      for t in (q, k, v, g))
    want, vjp = jax.vjp(
        lambda a, b_, c: jattn.fused_attention(a, b_, c, jnp.asarray(
            mask.numpy())), jq, jk, jv)
    o, stats = rows_forward(q, k, v, bias)
    real = slice(None, -1)
    to_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    assert_close(o[real], to_torch(want)[real], RTOL[dtype], "out")
    got = rows_backward(q, k, v, bias, g, stats)
    for name, x, w in zip(("dq", "dk", "dv"), got, vjp(jg)):
        assert_close(x[real], to_torch(w)[real], RTOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 31, 33, 50, 256, 512, 513, 544, 1024, 2049])
def test_attention_plan_names_a_form_for_every_call(d, dtype):
    """Every (D, Lk, dtype) has a form that exists; (nc, slices) is the
    online forms' plan in every form; the online form exactly where the
    rule keeps it (up to D = 512: f32, and bf16 with at most 32 keys), the
    rows form exactly where the rule puts it (up to 256 keys otherwise, for
    f32 from 96 keys), the sliced form elsewhere."""
    for lk in (1, 16, 32, 33, 51, 95, 96, 201, 256, 257, 1000):
        plan = attention.attention_plan(d, lk, dtype)
        assert plan.form in attention.FORMS
        assert (plan.nc, plan.slices) == attention.attention_plan(d)[:2]
        bf16 = dtype == torch.bfloat16
        wide = d > attention.SLICE_COLUMNS
        if not wide and (not bf16 or lk <= attention.ONLINE_MAX_KEYS_BF16):
            assert plan.form == attention.FORM_ONLINE
        elif lk <= attention.ROWS_MAX_KEYS and (
                bf16 or lk >= attention.ROWS_MIN_KEYS_F32):
            assert plan.form == attention.FORM_ROWS
        else:
            assert plan.form == attention.FORM_SLICED
    with pytest.raises(ValueError):
        attention.attention_plan(d, 0, dtype)


def test_the_forms_of_the_main_paths_calls():
    """The six attention calls of both flagships: in bf16 the rows form at
    h1024, and at h256 and hidden 50 wherever they attend over more than
    32 keys (eDOS and phDOS self-attention), the online form over the
    16-32 atom keys; in f32 at h1024 the rows form for the self-attention
    over 201 energy tokens and the sliced form over 16-51 keys; at h256
    and hidden 50 the online form."""
    for _, _, lk in CALLS.values():
        assert attention.attention_plan(
            1024, lk, torch.bfloat16).form == attention.FORM_ROWS
        for d in (50, 256):
            assert attention.attention_plan(d, lk, torch.bfloat16).form == (
                attention.FORM_ROWS if lk > 32 else attention.FORM_ONLINE)
            assert attention.attention_plan(
                d, lk, torch.float32).form == attention.FORM_ONLINE
        assert attention.attention_plan(1024, lk, torch.float32).form == (
            attention.FORM_ROWS if lk == 201 else attention.FORM_SLICED)
