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
memory) and its backward recomputes q, k and v and runs the attention
backward kernel and the LayerNorm backward kernel
(``csrc/layernorm_bwd.cu``); for CPU tensors both are the plain composition
:func:`ln_attention_reference`.
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.nn.layernorm import ln_backward
from dostransformer_tpu_torch.ops import kernels

NEG_INF = -1e30
LN_EPS_ATTN = 1e-5  # the transformer's LayerNorm eps (nn.LayerNorm default)


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, Lk] bool (True = attend) -> additive f32 bias (0 or NEG_INF)."""
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask, zero, NEG_INF)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Lq, D], k/v [B, Lk, D], key_mask [B, Lk] (True = attend) or
    None -> [B, Lq, D] in q's dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if key_mask is not None:
        scores = scores + key_bias(key_mask)[:, None, :].to(acc)
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
    the backward kernel forms it. Returns (dq, dk, dv)."""
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
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g.to(acc), v.to(acc).transpose(-1, -2))
    ds = (p32 * (dp - (dp * p32).sum(-1, keepdim=True))).to(q.dtype)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _check_width(kernel: str, d: int):
    limit = kernels.library().dostpu_attention_max_dim()
    if d % 32 != 0 or d > limit:
        raise ValueError(f"{kernel}: feature width {d} must be a multiple of "
                         f"32 and at most {limit}")


def fused_attention_fwd(q, k, v, bias, want_stats=False):
    """The forward kernel (``csrc/attention.cu``) for an additive bias
    [B, Lk]: returns (out, stats), stats the rows' [2, B, Lq] max and sum
    for the backward kernel, or None unless ``want_stats``. k and v may be
    one tensor (the kernel then stages each tile once). CUDA tensors only
    (float32, contiguous, D a multiple of 32; anything else raises). Counted
    in ``fused_attention.launches``."""
    if not q.is_cuda:
        raise ValueError("fused_attention_fwd: the kernel takes CUDA tensors; "
                         "use dot_product_attention on the CPU")
    b, lq, d = q.shape
    lk = k.shape[1]
    _check_width("fused_attention", d)
    operands = {"q": (q, (b, lq, d)), "k": (k, (b, lk, d)),
                "v": (v, (b, lk, d)), "key_mask": (bias, (b, lk))}
    for arg, (t, shape) in operands.items():
        kernels.require("fused_attention", arg, t, device=q.device,
                        dtype=torch.float32, shape=shape)
    out = torch.empty_like(q)
    stats = (torch.empty((2, b, lq), device=q.device, dtype=torch.float32)
             if want_stats else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr() if want_stats else None, b, lq,
            lk, d, d ** -0.5, stream)
    kernels.check(code, "fused_attention")
    fused_attention.launches += 1
    return out, stats


def fused_attention_bwd(q, k, v, bias, o, g, stats=None):
    """The backward kernel (``csrc/attention_bwd.cu``): (dq, dk, dv) for the
    forward output o and upstream gradient g, both [B, Lq, D]; bias [B, Lk]
    is additive. ``stats`` is the forward kernel's [2, B, Lq] row max and
    row sum; without it the kernel recomputes them first, to the same bits.
    Same result as :func:`attention_bwd_reference`. CUDA tensors only
    (float32, contiguous, D a multiple of 32; anything else raises).
    ``fused_attention_bwd.launches`` counts calls that launched the
    kernels (one per call, however many kernels it takes)."""
    if not q.is_cuda:
        raise ValueError("fused_attention_bwd: the kernel takes CUDA tensors; "
                         "use attention_bwd_reference on the CPU")
    b, lq, d = q.shape
    lk = k.shape[1]
    _check_width("fused_attention_bwd", d)
    g = g.contiguous()
    operands = {"q": (q, (b, lq, d)), "k": (k, (b, lk, d)),
                "v": (v, (b, lk, d)), "bias": (bias, (b, lk)),
                "o": (o, (b, lq, d)), "g": (g, (b, lq, d))}
    if stats is not None:
        operands["stats"] = (stats, (2, b, lq))
    for arg, (t, shape) in operands.items():
        kernels.require("fused_attention_bwd", arg, t, device=q.device,
                        dtype=torch.float32, shape=shape)
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
            o.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if stats is None else stats.data_ptr(),
            scratch.data_ptr(), b, lq, lk, d, d ** -0.5, stream)
    kernels.check(code, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


def _bias(q: torch.Tensor, lk: int, key_mask: torch.Tensor | None):
    if key_mask is None:
        return torch.zeros((q.shape[0], lk), device=q.device,
                           dtype=torch.float32)
    return key_bias(key_mask)


class _FusedAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or the plain
    versions (CPU). Saves q, k, v, the key mask, the output o (the
    backward's delta is rowsum(g * o)) and, on the card when a gradient is
    wanted, the forward kernel's row statistics. k and v may be one tensor;
    autograd then sums dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        stats = None
        if q.is_cuda:
            o, stats = fused_attention_fwd(
                q, k, v, _bias(q, k.shape[1], key_mask),
                want_stats=any(ctx.needs_input_grad[:3]))
        else:
            o = dot_product_attention(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o, stats)
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

    CUDA tensors go through the kernels (float32, contiguous, D a multiple
    of 32; anything else raises), CPU tensors through the plain versions.
    ``fused_attention.launches`` counts forward kernel launches."""
    return _FusedAttention.apply(q, k, v, key_mask)


fused_attention.launches = 0


def _ln_apply(x, scale, bias):
    """The shared LayerNorm of the attention inputs, eps 1e-5, statistics in
    f32 or wider. Returns (y in x's dtype, xhat and rstd in f32 or wider)."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f)
    y, mu, rstd = torch.native_layer_norm(xf, xf.shape[-1:], scale.to(f),
                                          bias.to(f), LN_EPS_ATTN)
    return y.to(x.dtype), (xf - mu) * rstd, rstd


def ln_attention_reference(x: torch.Tensor, x_k: torch.Tensor,
                           x_v: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor,
                           key_mask: torch.Tensor | None = None):
    """Plain composition: the shared LayerNorm on x [B, Lq, D], x_k and x_v
    [B, Lk, D], then :func:`dot_product_attention` -> [B, Lq, D] in x's
    dtype."""
    q, k, v = (_ln_apply(t, ln_scale, ln_bias)[0] for t in (x, x_k, x_v))
    return dot_product_attention(q, k, v, key_mask)


def _fused_attention_ln_fwd(x, x_k, x_v, ln_scale, ln_bias, bias):
    """Launch the LN-fused forward kernel (CUDA tensors only)."""
    b, lq, d = x.shape
    lk = x_k.shape[1]
    _check_width("fused_attention_ln", d)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_ln: x is {x.dtype}, the kernel "
                        f"takes float32 or bfloat16")
    operands = {"x": (x, x.dtype, (b, lq, d)), "x_k": (x_k, x.dtype,
                (b, lk, d)), "x_v": (x_v, x.dtype, (b, lk, d)),
                "ln_scale": (ln_scale, torch.float32, (d,)),
                "ln_bias": (ln_bias, torch.float32, (d,)),
                "key_mask": (bias, torch.float32, (b, lk))}
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("fused_attention_ln", arg, t, device=x.device,
                        dtype=dtype, shape=shape)
    out = torch.empty_like(x)
    # per-row (mean, rstd) of the three inputs: the only LN data in memory
    stats = torch.empty((2 * b * (lq + 2 * lk),), device=x.device,
                        dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_ln_fwd(
            x.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), bias.data_ptr(), out.data_ptr(),
            stats.data_ptr(), b, lq, lk, d, d ** -0.5, LN_EPS_ATTN,
            int(x.dtype == torch.bfloat16), stream)
    kernels.check(code, "fused_attention_ln")
    fused_attention_ln.launches += 1
    return out


class _FusedAttentionLN(torch.autograd.Function):
    """Saves the raw inputs, the LayerNorm parameters, the key mask and the
    output o: no LayerNorm output is kept. The backward recomputes q, k, v
    and their xhat and rstd with plain tensor code (as the JAX package
    does), takes dq, dk, dv from the attention backward (the kernel needs o
    for its row statistics, so o is saved rather than recomputed) and runs
    one LayerNorm backward per distinct input tensor: the LayerNorm backward
    is linear in its upstream gradient, so inputs that are one tensor have
    their gradients added first."""

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
        if x.is_cuda:
            o = _fused_attention_ln_fwd(x, x_k, x_v, ln_scale, ln_bias,
                                        _bias(x, x_k.shape[1], key_mask))
        else:
            o = ln_attention_reference(x, x_k, x_v, ln_scale, ln_bias,
                                       key_mask)
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
        for dy, (_, xhat, rstd) in ((dq, lnq), (dk, lnk), (dv, lnv)):
            if dy is None:
                grads.append(None)
                continue
            dx, ds, db = ln_backward(xhat.to(dy.dtype), rstd, ln_scale, dy)
            grads.append(dx)
            dscale, dbias = dscale + ds, dbias + db
        return (*grads, dscale, dbias, None)


def fused_attention_ln(x: torch.Tensor, x_k: torch.Tensor, x_v: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                       key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as :func:`ln_attention_reference`, differentiable in x,
    x_k, x_v, ln_scale and ln_bias; x_k, x_v and x may be one tensor.

    CUDA tensors go through the kernels (inputs of one dtype, float32 or
    bfloat16, ln_scale and ln_bias float32, D a multiple of 32; anything
    else raises; the backward kernels take float32), CPU tensors through
    the plain versions. ``fused_attention_ln.launches`` counts forward
    kernel launches."""
    return _FusedAttentionLN.apply(x, x_k, x_v, ln_scale, ln_bias, key_mask)


fused_attention_ln.launches = 0
