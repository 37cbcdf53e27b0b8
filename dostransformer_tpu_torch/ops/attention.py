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
the kernel in ``csrc/attention_bwd.cu``, at every shape; for CPU tensors
they are :func:`dot_product_attention` and :func:`attention_bwd_reference`.
Nothing else chooses the path. Layout is batch-first ``[B, L, D]`` as in the
JAX package.
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.ops import kernels

NEG_INF = -1e30


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


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            g: torch.Tensor):
    """Plain backward of ``softmax(q k^T * D^-0.5 + bias) v`` for the upstream
    gradient g [B, Lq, D]; bias [B, Lk] is additive (0 or NEG_INF). The
    counterpart of the JAX package's ``_softmax_attn_bwd``: scores and dp
    accumulate in at least f32, the softmax runs at f32, and
    ``ds = p * (dp - rowsum(dp * p))``. Returns (dq, dk, dv)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    s = (torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
         + bias[:, None, :].to(acc))
    p32 = torch.softmax(s.to(torch.float32), dim=-1)
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


def _fused_attention_fwd(q, k, v, bias):
    """Launch the forward kernel (CUDA tensors only)."""
    b, lq, d = q.shape
    lk = k.shape[1]
    _check_width("fused_attention", d)
    operands = {"q": (q, (b, lq, d)), "k": (k, (b, lk, d)),
                "v": (v, (b, lk, d)), "key_mask": (bias, (b, lk))}
    for arg, (t, shape) in operands.items():
        kernels.require("fused_attention", arg, t, device=q.device,
                        dtype=torch.float32, shape=shape)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, lq, lk, d, d ** -0.5, stream)
    kernels.check(code, "fused_attention")
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q, k, v, bias, o, g):
    """The backward kernel (``csrc/attention_bwd.cu``): (dq, dk, dv) for the
    forward output o and upstream gradient g, both [B, Lq, D]; bias [B, Lk]
    is additive. Same result as :func:`attention_bwd_reference`. CUDA
    tensors only (float32, contiguous, D a multiple of 32; anything else
    raises). ``fused_attention_bwd.launches`` counts kernel launches."""
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
    for arg, (t, shape) in operands.items():
        kernels.require("fused_attention_bwd", arg, t, device=q.device,
                        dtype=torch.float32, shape=shape)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3 * b * lq,), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, lq, lk, d, d ** -0.5, stream)
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
    versions (CPU). Saves q, k, v, the key mask and the output o (the
    backward's row statistics use rowsum(g * o)). k and v may be one tensor;
    autograd then sums dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        if q.is_cuda:
            o = _fused_attention_fwd(q, k, v, _bias(q, k.shape[1], key_mask))
        else:
            o = dot_product_attention(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, o = ctx.saved_tensors
        bias = _bias(q, k.shape[1], key_mask)
        if q.is_cuda:
            dq, dk, dv = fused_attention_bwd(q, k, v, bias, o, g)
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
