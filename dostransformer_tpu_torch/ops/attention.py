"""Projection-free scaled dot-product attention: CUDA kernel and its plain
version.

Counterpart of dostransformer_tpu/ops/attention.py (forward only):
``softmax(q k^T * D^-0.5 + key_bias) v`` with one head, no projections, f32
accumulation and the softmax at exactly f32. A masked key carries the finite
additive bias ``NEG_INF = -1e30``, so a row whose keys are all masked (a
dummy graph of a short batch) averages the values uniformly instead of
producing NaN.

:func:`fused_attention` runs the kernel in ``csrc/attention.cu`` for CUDA
tensors and :func:`dot_product_attention` for CPU tensors; nothing else
chooses the path. Layout is batch-first ``[B, L, D]`` as in the JAX package.
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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as :func:`dot_product_attention`.

    CUDA tensors go through the kernel (float32, contiguous, D a multiple of
    32; anything else raises), CPU tensors through
    :func:`dot_product_attention`. ``fused_attention.launches`` counts kernel
    launches."""
    if not q.is_cuda:
        return dot_product_attention(q, k, v, key_mask)
    b, lq, d = q.shape
    lk = k.shape[1]
    lib = kernels.library()
    if d % 32 != 0 or d > lib.dostpu_attention_max_dim():
        raise ValueError(f"fused_attention: feature width {d} must be a "
                         f"multiple of 32 and at most "
                         f"{lib.dostpu_attention_max_dim()}")
    if key_mask is None:
        bias = torch.zeros((b, lk), device=q.device, dtype=torch.float32)
    else:
        bias = key_bias(key_mask)
    operands = {"q": (q, (b, lq, d)), "k": (k, (b, lk, d)),
                "v": (v, (b, lk, d)), "key_mask": (bias, (b, lk))}
    for arg, (t, shape) in operands.items():
        kernels.require("fused_attention", arg, t, device=q.device,
                        dtype=torch.float32, shape=shape)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, lq, lk, d, d ** -0.5, stream)
    kernels.check(code, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
