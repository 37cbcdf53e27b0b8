"""Projection-free scaled dot-product attention: CUDA kernel and its plain
version.

Counterpart of dostransformer_tpu/ops/attention.py:
``softmax(q k^T * D^-0.5 + key_bias) v`` with one head, no projections, f32
accumulation and the softmax at exactly f32. A masked key carries the finite
additive bias ``NEG_INF = -1e30``, so a row whose keys are all masked (a
dummy graph of a short batch) averages the values uniformly instead of
producing NaN.

:func:`fused_attention` is differentiable in q, k and v (a
``torch.autograd.Function``; the key mask gets no gradient): for CUDA
tensors its forward is the kernel in ``csrc/attention.cu`` and its backward
the kernel in ``csrc/attention_bwd.cu`` (both 3xTF32 tensor-core products
at f32 accuracy; the forward hands its row max and sum to the backward), at
every shape; for CPU tensors
they are :func:`dot_product_attention` and :func:`attention_bwd_reference`.
Nothing else chooses the path. Layout is batch-first ``[B, L, D]`` as in the
JAX package.

:func:`fused_attention_ln` is the LayerNorm-fused variant (the JAX package's
``fused_attention_ln``): one shared LayerNorm applied to the query, key and
value inputs and then the same attention, differentiable in the three inputs
and the LayerNorm's scale and bias. For CUDA tensors its forward is the
kernel in ``csrc/attention_ln.cu`` (no LayerNorm output reaches device
memory: the attention kernel's tensor-core design with every staged tile
normalised in place in shared memory, one launch) and its backward
recomputes q, k and v, runs the attention backward kernel, and hands the
LayerNorm backward kernel (``csrc/layernorm_bwd.cu``) the raw inputs with
their row means and rstd, so no xhat is written to memory; for CPU tensors
both are the plain composition :func:`ln_attention_reference`.

bf16 operands (a bf16 model): the forward kernel has a bf16 form (q, k, v
and the output bf16; scores, softmax and the row statistics f32) that
rounds where the TPU kernel and :func:`dot_product_attention` round: the
normalised softmax weights to bf16, then the output (two passes over the
keys, see ``csrc/attention.cu``). So has the backward kernel (q, k, v, g
and dq, dk, dv bf16), which rounds where the TPU kernel ``_attn_bwd_kernel``
and :func:`attention_bwd_reference` round: p and ds to bf16 before their
products, each output once after its scale; it forms delta from dp and the
f32 softmax, not from the rounded output (see ``csrc/attention_bwd.cu``).

The three attention kernels take every feature width D >= 1:
:func:`attention_plan` is the Python mirror of how they split it (rows
staged at ceil(D / 32) x 32 columns up to D = 512; above it blocks that each
own a slice of 512 output columns).
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.nn.layernorm import ln_backward
from dostransformer_tpu_torch.ops import kernels

NEG_INF = -1e30
# the widest row the attention kernels stage whole: 16 groups of 32 columns
# (``attn::kSliceMaxNC`` of csrc/attention_core.cuh)
SLICE_COLUMNS = 512
LN_EPS_ATTN = 1e-5  # the transformer's LayerNorm eps (nn.LayerNorm default)


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, Lk] bool (True = attend) -> additive f32 bias (0 or NEG_INF)."""
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask, zero, NEG_INF)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Lq, D], k/v [B, Lk, D], key_mask [B, Lk] (True = attend) or
    None -> [B, Lq, D] in q's dtype."""
    return biased_attention_reference(
        q, k, v, None if key_mask is None else key_bias(key_mask))


def biased_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               bias: torch.Tensor | None) -> torch.Tensor:
    """:func:`dot_product_attention` with the key mask given as its additive
    bias [B, Lk] (0 or NEG_INF; None for no mask), as the forward kernel
    takes it."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias[:, None, :].to(acc)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.matmul(weights.to(acc), v.to(acc)).to(q.dtype)


def attention_stats_reference(q: torch.Tensor, k: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's row statistics: [2, B, Lq] f32,
    the row max m of ``s = q k^T * D^-0.5 + bias`` and the row sum l of
    ``exp(s - m)``. They are kept apart, not as one log-sum-exp: a fully
    masked row has m = -1e30 and l = Lk, and -1e30 + log(Lk) rounds back to
    -1e30."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    s = (torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
         + bias[:, None, :].to(acc)).to(torch.float32)
    m = s.amax(-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1)])


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            g: torch.Tensor,
                            stats: torch.Tensor | None = None):
    """Plain backward of ``softmax(q k^T * D^-0.5 + bias) v`` for the upstream
    gradient g [B, Lq, D]; bias [B, Lk] is additive (0 or NEG_INF). The
    counterpart of the JAX package's ``_softmax_attn_bwd``: scores and dp
    accumulate in at least f32, the softmax runs at f32, and
    ``ds = p * (dp - rowsum(dp * p))``. With ``stats`` (the forward's
    [2, B, Lq] row max and row sum) the softmax is ``exp(s - m) / l``, as
    the backward kernel forms it. bf16 operands round where the JAX Pallas
    kernel ``_attn_bwd_kernel`` rounds: p and ds to bf16 before their
    products, which sum in f32; dv once, dq and dk once after the scale
    (the JAX ``_softmax_attn_bwd`` rounds dq and dk before the scale as
    well: one rounding more where the scale is no power of 2). Returns
    (dq, dk, dv) in q's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    s = (torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
         + bias[:, None, :].to(acc))
    if stats is None:
        p32 = torch.softmax(s.to(torch.float32), dim=-1)
    else:
        p32 = (torch.exp(s.to(torch.float32) - stats[0][..., None])
               / stats[1][..., None])
    p = p32.to(q.dtype)
    dv = torch.matmul(p.transpose(-1, -2).to(acc), g.to(acc)).to(q.dtype)
    dp = torch.matmul(g.to(acc), v.to(acc).transpose(-1, -2))
    ds = (p32 * (dp - (dp * p32).sum(-1, keepdim=True))).to(q.dtype)
    dq = (torch.matmul(ds.to(acc), k.to(acc)) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2).to(acc), q.to(acc))
          * scale).to(q.dtype)
    return dq, dk, dv


def attention_plan(d: int) -> tuple[int, int]:
    """(32-column groups a staged row holds, blocks that share a row's
    output columns) of the attention kernels at feature width d: the mirror
    of ``dostpu_attention_plan`` in csrc/attention.cu, which the card run
    holds equal. (ceil(d / 32), 1) up to d = 512, else (16, ceil(d / 512)):
    the sliced kernels."""
    if d < 1:
        raise ValueError(f"attention: feature width {d} must be at least 1")
    if d <= SLICE_COLUMNS:
        return -(-d // 32), 1
    return SLICE_COLUMNS // 32, -(-d // SLICE_COLUMNS)


def fused_attention_fwd(q, k, v, bias, want_stats=False):
    """The forward kernel (``csrc/attention.cu``) for an additive bias
    [B, Lk]: returns (out, stats), stats the rows' [2, B, Lq] max and sum
    for the backward kernel, or None unless ``want_stats``. k and v may be
    one tensor (the kernel then stages each tile once). CUDA tensors only
    (q, k and v of one dtype, float32 or bfloat16; bias float32;
    contiguous, any D >= 1; anything else raises). Counted in
    ``fused_attention.launches``."""
    if not q.is_cuda:
        raise ValueError("fused_attention_fwd: the kernel takes CUDA tensors; "
                         "use dot_product_attention on the CPU")
    b, lq, d = q.shape
    lk = k.shape[1]
    attention_plan(d)
    kernels.require("fused_attention", "q", q, device=q.device,
                    dtype={torch.float32, torch.bfloat16}, shape=(b, lq, d))
    operands = {"k": (k, q.dtype, (b, lk, d)), "v": (v, q.dtype, (b, lk, d)),
                "key_mask": (bias, torch.float32, (b, lk))}
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("fused_attention", arg, t, device=q.device,
                        dtype=dtype, shape=shape)
    out = torch.empty_like(q)
    stats = (torch.empty((2, b, lq), device=q.device, dtype=torch.float32)
             if want_stats else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr() if want_stats else None, b, lq,
            lk, d, d ** -0.5, int(q.dtype == torch.bfloat16), stream)
    kernels.check(code, "fused_attention")
    fused_attention.launches += 1
    return out, stats


def fused_attention_bwd(q, k, v, bias, o, g, stats=None):
    """The backward kernel (``csrc/attention_bwd.cu``): (dq, dk, dv) for the
    forward output o and upstream gradient g, both [B, Lq, D]; bias [B, Lk]
    is additive. ``stats`` is the forward kernel's [2, B, Lq] row max and
    row sum; without it the kernel recomputes them first, to the same bits.
    Same result as :func:`attention_bwd_reference`. CUDA tensors only: q,
    k, v and g of one dtype, float32 or bfloat16 (the bf16 form, which
    returns bf16 gradients and reads no o: pass it or None), o float32 for
    the f32 form, bias and stats float32; contiguous, any D >= 1; anything
    else raises. ``fused_attention_bwd.launches`` counts calls that
    launched the kernels (one per call, however many kernels it takes)."""
    if not q.is_cuda:
        raise ValueError("fused_attention_bwd: the kernel takes CUDA tensors; "
                         "use attention_bwd_reference on the CPU")
    b, lq, d = q.shape
    lk = k.shape[1]
    attention_plan(d)
    g = g.contiguous()
    kernels.require("fused_attention_bwd", "q", q, device=q.device,
                    dtype={torch.float32, torch.bfloat16}, shape=(b, lq, d))
    bf16 = q.dtype == torch.bfloat16
    operands = {"k": (k, q.dtype, (b, lk, d)), "v": (v, q.dtype, (b, lk, d)),
                "bias": (bias, torch.float32, (b, lk)),
                "g": (g, q.dtype, (b, lq, d))}
    if not bf16:
        operands["o"] = (o, torch.float32, (b, lq, d))
    if stats is not None:
        operands["stats"] = (stats, torch.float32, (2, b, lq))
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("fused_attention_bwd", arg, t, device=q.device,
                        dtype=dtype, shape=shape)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library()
    # row statistics and delta, and the query chunks' partial dk and dv
    scratch = torch.empty(
        (lib.dostpu_attention_bwd_scratch_floats(b, lq, lk, d),),
        device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if bf16 else o.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if stats is None else stats.data_ptr(), scratch.data_ptr(),
            b, lq, lk, d, d ** -0.5, int(bf16), stream)
    kernels.check(code, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


def _bias(q: torch.Tensor, lk: int, key_mask: torch.Tensor | None):
    if key_mask is None:
        return torch.zeros((q.shape[0], lk), device=q.device,
                           dtype=torch.float32)
    return key_bias(key_mask)


@torch.library.custom_op("dostpu::attention_fwd", mutates_args=(),
                         device_types="cuda")
def attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, want_stats: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one opaque op (``torch.ops.dostpu.attention_fwd``), so
    that ``torch.export`` and CUDA graphs see one node a launch: CUDA tensors
    launch the kernel (:func:`fused_attention_fwd`), CPU tensors run
    :func:`biased_attention_reference`. Returns (out, stats): stats the
    [2, B, Lq] row max and sum when ``want_stats``, else an empty tensor (an
    op returns no None)."""
    out, stats = fused_attention_fwd(q, k, v, bias, want_stats)
    return out, (stats if want_stats else _no_stats(q))


def _no_stats(q):
    return q.new_empty((0,), dtype=torch.float32)


@attention_fwd_op.register_kernel("cpu")
def _(q, k, v, bias, want_stats):
    stats = (attention_stats_reference(q, k, bias) if want_stats
             else _no_stats(q))
    return biased_attention_reference(q, k, v, bias), stats


@attention_fwd_op.register_fake
def _(q, k, v, bias, want_stats):
    b, lq, _ = q.shape
    stats = (q.new_empty((2, b, lq), dtype=torch.float32) if want_stats
             else _no_stats(q))
    return torch.empty_like(q), stats


class _FusedAttention(torch.autograd.Function):
    """Forward through :func:`attention_fwd_op` (the kernel on CUDA, the
    plain version on the CPU); backward through the backward kernel (CUDA)
    or its plain version (CPU). Saves q, k, v, the key mask, the output o
    (the f32 backward kernel's delta is rowsum(g * o)) and, on the card when
    a gradient is wanted, the forward kernel's row statistics. k and v may
    be one tensor; autograd then sums dk and dv. bf16 operands give bf16
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        want_stats = q.is_cuda and any(ctx.needs_input_grad[:3])
        o, stats = attention_fwd_op(q, k, v, _bias(q, k.shape[1], key_mask),
                                    want_stats)
        ctx.save_for_backward(q, k, v, key_mask, o,
                              stats if want_stats else None)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, o, stats = ctx.saved_tensors
        bias = _bias(q, k.shape[1], key_mask)
        if q.is_cuda:
            dq, dk, dv = fused_attention_bwd(q, k, v, bias, o, g, stats)
        else:
            dq, dk, dv = attention_bwd_reference(q, k, v, bias, g)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as :func:`dot_product_attention`, differentiable in q,
    k and v.

    CUDA tensors go through the kernels (float32, or the forward's bf16
    form for bf16 operands; contiguous, any D >= 1; anything else raises),
    CPU tensors through the plain versions.
    ``fused_attention.launches`` counts forward kernel launches."""
    return _FusedAttention.apply(q, k, v, key_mask)


fused_attention.launches = 0


def _ln_apply(x, scale, bias):
    """The shared LayerNorm of the attention inputs, eps 1e-5, statistics in
    f32 or wider. Returns (y in x's dtype, the rows' mean and rstd [..., 1]
    in f32 or wider)."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f)
    y, mu, rstd = torch.native_layer_norm(xf, xf.shape[-1:], scale.to(f),
                                          bias.to(f), LN_EPS_ATTN)
    return y.to(x.dtype), mu, rstd


def ln_attention_reference(x: torch.Tensor, x_k: torch.Tensor,
                           x_v: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor,
                           key_mask: torch.Tensor | None = None):
    """Plain composition: the shared LayerNorm on x [B, Lq, D], x_k and x_v
    [B, Lk, D], then :func:`dot_product_attention` -> [B, Lq, D] in x's
    dtype."""
    q, k, v = (_ln_apply(t, ln_scale, ln_bias)[0] for t in (x, x_k, x_v))
    return dot_product_attention(q, k, v, key_mask)


def _fused_attention_ln_fwd(x, x_k, x_v, ln_scale, ln_bias, key_mask):
    """Launch the LN-fused forward kernel (CUDA tensors only). ``key_mask``
    is None or [B, Lk] bool: the kernel forms the additive bias itself."""
    b, lq, d = x.shape
    lk = x_k.shape[1]
    attention_plan(d)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_ln: x is {x.dtype}, the kernel "
                        f"takes float32 or bfloat16")
    operands = {"x": (x, x.dtype, (b, lq, d)), "x_k": (x_k, x.dtype,
                (b, lk, d)), "x_v": (x_v, x.dtype, (b, lk, d)),
                "ln_scale": (ln_scale, torch.float32, (d,)),
                "ln_bias": (ln_bias, torch.float32, (d,))}
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("fused_attention_ln", arg, t, device=x.device,
                        dtype=dtype, shape=shape)
    if key_mask is not None:
        if (key_mask.device != x.device or key_mask.dtype != torch.bool
                or tuple(key_mask.shape) != (b, lk)):
            raise ValueError(
                f"fused_attention_ln: key_mask must be a bool tensor of "
                f"shape {(b, lk)} on {x.device}, got {key_mask.dtype} "
                f"{tuple(key_mask.shape)} on {key_mask.device}")
        key_mask = key_mask.contiguous()  # bytes: no alignment needed
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_ln_fwd(
            x.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(), b, lq, lk, d, d ** -0.5, LN_EPS_ATTN,
            int(x.dtype == torch.bfloat16), stream)
    kernels.check(code, "fused_attention_ln")
    fused_attention_ln.launches += 1
    return out


@torch.library.custom_op("dostpu::attention_ln_fwd", mutates_args=(),
                         device_types="cuda")
def attention_ln_fwd_op(x: torch.Tensor, x_k: torch.Tensor, x_v: torch.Tensor,
                        ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                        key_mask: torch.Tensor | None) -> torch.Tensor:
    """The LN-fused forward as one opaque op
    (``torch.ops.dostpu.attention_ln_fwd``): CUDA tensors launch the kernel,
    CPU tensors run :func:`ln_attention_reference`."""
    return _fused_attention_ln_fwd(x, x_k, x_v, ln_scale, ln_bias, key_mask)


@attention_ln_fwd_op.register_kernel("cpu")
def _(x, x_k, x_v, ln_scale, ln_bias, key_mask):
    return ln_attention_reference(x, x_k, x_v, ln_scale, ln_bias, key_mask)


@attention_ln_fwd_op.register_fake
def _(x, x_k, x_v, ln_scale, ln_bias, key_mask):
    return torch.empty_like(x)


class _FusedAttentionLN(torch.autograd.Function):
    """Saves the raw inputs, the LayerNorm parameters, the key mask and the
    output o: no LayerNorm output is kept. The backward recomputes q, k, v
    with their rows' mean and rstd (one ``native_layer_norm`` per distinct
    tensor), takes dq, dk, dv from the attention backward (its f32 form
    needs o for delta, so o is saved rather than recomputed) and runs
    one LayerNorm backward per distinct input tensor on the raw input with
    (mean, rstd): xhat is formed inside that backward, never written out.
    The LayerNorm backward is linear in its upstream gradient, so inputs
    that are one tensor have their gradients added first."""

    @staticmethod
    def forward(ctx, x, x_k, x_v, ln_scale, ln_bias, key_mask):
        ctx.k_is_q = x_k is x
        ctx.v_is_k = x_v is x_k
        ctx.v_is_q = x_v is x
        # the kernels take contiguous rows (an expanded token table is not);
        # tensors that were one stay one
        x = x.contiguous()
        x_k = x if ctx.k_is_q else x_k.contiguous()
        x_v = (x_k if ctx.v_is_k else x if ctx.v_is_q
               else x_v.contiguous())
        o = attention_ln_fwd_op(x, x_k, x_v, ln_scale, ln_bias, key_mask)
        ctx.save_for_backward(x, x_k, x_v, ln_scale, ln_bias, key_mask, o)
        return o

    @staticmethod
    def backward(ctx, g):
        x, x_k, x_v, ln_scale, ln_bias, key_mask, o = ctx.saved_tensors
        lnq = _ln_apply(x, ln_scale, ln_bias)
        lnk = lnq if ctx.k_is_q else _ln_apply(x_k, ln_scale, ln_bias)
        lnv = (lnk if ctx.v_is_k else lnq if ctx.v_is_q
               else _ln_apply(x_v, ln_scale, ln_bias))
        bias = _bias(x, x_k.shape[1], key_mask)
        if x.is_cuda:
            dq, dk, dv = fused_attention_bwd(lnq[0], lnk[0], lnv[0], bias, o,
                                             g)
        else:
            dq, dk, dv = attention_bwd_reference(lnq[0], lnk[0], lnv[0],
                                                 bias, g)
        # fold the gradients of inputs that are one tensor into one slot
        if ctx.v_is_k:
            dk, dv = dk + dv, None
        elif ctx.v_is_q:
            dq, dv = dq + dv, None
        if ctx.k_is_q:
            dq, dk = dq + dk, None
        grads, dscale, dbias = [], 0.0, 0.0
        for dy, raw, (_, mean, rstd) in ((dq, x, lnq), (dk, x_k, lnk),
                                         (dv, x_v, lnv)):
            if dy is None:
                grads.append(None)
                continue
            dx, ds, db = ln_backward(raw, rstd, ln_scale, dy, mean)
            grads.append(dx)
            dscale, dbias = dscale + ds, dbias + db
        return (*grads, dscale, dbias, None)


def fused_attention_ln(x: torch.Tensor, x_k: torch.Tensor, x_v: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                       key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as :func:`ln_attention_reference`, differentiable in x,
    x_k, x_v, ln_scale and ln_bias; x_k, x_v and x may be one tensor.

    CUDA tensors go through the kernels (inputs of one dtype, float32 or
    bfloat16, ln_scale and ln_bias float32, any D >= 1, forward and
    backward; anything else raises), CPU tensors through the plain versions.
    ``fused_attention_ln.launches`` counts forward kernel launches."""
    return _FusedAttentionLN.apply(x, x_k, x_v, ln_scale, ln_bias, key_mask)


fused_attention_ln.launches = 0
