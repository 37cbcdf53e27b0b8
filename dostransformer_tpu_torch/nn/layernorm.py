"""LayerNorm with f32 statistics, and its low-precision-residual variant.

Counterpart of dostransformer_tpu/nn/layernorm.py.

:func:`layer_norm` / :class:`LayerNorm` are the default path: statistics in
float32 or wider whatever the operand dtype, the output cast back to the
operand dtype, PyTorch's own backward.

:func:`layer_norm_lp` / :class:`LayerNormLP` are the counterpart of the JAX
package's ``layer_norm_lp``: the same forward written out (f32 statistics
with the fast variance ``E[x^2] - E[x]^2`` clamped at 0, scale and bias
applied in f32, output cast to the operand dtype), and a backward of its
own that keeps xhat **in the operand dtype** (bf16 under bf16 operands),
rstd in f32, and computes

    dx     = rstd * (g - mean_d(g) - xhat * mean_d(g * xhat)),  g = dy * scale
    dscale = sum_leading(dy * xhat)
    dbias  = sum_leading(dy)

For CUDA tensors the backward is the kernel in ``csrc/layernorm_bwd.cu``
(:func:`layer_norm_bwd`: one pass over dy and xhat, all arithmetic f32,
f32 and bf16 operands, any number of rows), for CPU tensors the plain
:func:`ln_bwd_reference`. Nothing else chooses the path. f64 operands stay
f64 on the plain path; the kernel refuses them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dostransformer_tpu_torch.ops import kernels

LN_EPS = 1e-5  # torch nn.LayerNorm default
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    f = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(f), x.shape[-1:], weight.to(f), bias.to(f),
                        eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (same parameters and state_dict keys) that normalises
    with :func:`layer_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _ln_lp_fwd(x, scale, bias, eps):
    """(y in x's dtype, xhat in x's dtype, rstd [..., 1] in f32 or wider)."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f)
    mu = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    rstd = torch.rsqrt((mean2 - mu * mu).clamp_min(0.0) + eps)
    centred = xf - mu
    y = (centred * (rstd * scale.to(f)) + bias.to(f)).to(x.dtype)
    return y, (centred * rstd).to(x.dtype), rstd


def ln_bwd_reference(xhat: torch.Tensor, rstd: torch.Tensor,
                     scale: torch.Tensor, dy: torch.Tensor):
    """Plain xhat-form LayerNorm backward: xhat and dy [..., D] in the
    operand dtype, rstd [..., 1], scale [D] -> (dx in dy's dtype, dscale and
    dbias [D] in scale's dtype). The row and column sums accumulate in f32
    or wider over the operand-dtype products, as the JAX package's
    ``_ln_bwd_jnp`` does."""
    f = torch.promote_types(dy.dtype, torch.float32)
    d = xhat.shape[-1]
    g = dy * scale.to(dy.dtype)
    s1 = g.sum(-1, keepdim=True, dtype=f) / d
    s2 = (g * xhat).sum(-1, keepdim=True, dtype=f) / d
    dx = (rstd * (g.to(f) - s1 - xhat.to(f) * s2)).to(dy.dtype)
    lead = tuple(range(dy.dim() - 1))
    dscale = (dy * xhat).sum(lead, dtype=f).to(scale.dtype)
    dbias = dy.sum(lead, dtype=f).to(scale.dtype)
    return dx, dscale, dbias


def layer_norm_bwd(xhat: torch.Tensor, rstd: torch.Tensor,
                   scale: torch.Tensor, dy: torch.Tensor):
    """The backward kernel (``csrc/layernorm_bwd.cu``): same contract as
    :func:`ln_bwd_reference`, with g = dy * scale kept in f32. CUDA tensors
    only: xhat and dy float32 or bfloat16 (one dtype), rstd and scale
    float32, D a multiple of 32 up to the attention kernels' width limit;
    anything else raises. The leading dimensions are flattened to rows, any
    count >= 1. ``layer_norm_bwd.launches`` counts kernel launches."""
    if not dy.is_cuda:
        raise ValueError("layer_norm_bwd: the kernel takes CUDA tensors; use "
                         "ln_bwd_reference on the CPU")
    if dy.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"layer_norm_bwd: dy is {dy.dtype}, the kernel takes "
                        f"float32 or bfloat16")
    d = dy.shape[-1]
    lib = kernels.library()
    limit = lib.dostpu_attention_max_dim()
    if d % 32 != 0 or d > limit:
        raise ValueError(f"layer_norm_bwd: feature width {d} must be a "
                         f"multiple of 32 and at most {limit}")
    rows = dy.numel() // d
    if rows < 1:
        raise ValueError("layer_norm_bwd: no rows")
    dy, xhat = dy.contiguous(), xhat.contiguous()
    rstd = rstd.reshape(rows)
    operands = {"xhat": (xhat, dy.dtype, dy.shape), "dy": (dy, dy.dtype,
                dy.shape), "rstd": (rstd, torch.float32, (rows,)),
                "scale": (scale, torch.float32, (d,))}
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("layer_norm_bwd", arg, t, device=dy.device,
                        dtype=dtype, shape=shape)
    dx = torch.empty_like(dy)
    dscale = torch.empty(d, device=dy.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    partial = torch.empty((lib.dostpu_layer_norm_bwd_blocks(rows), 2, d),
                          device=dy.device, dtype=torch.float32)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_layer_norm_bwd(
            xhat.data_ptr(), rstd.data_ptr(), dy.data_ptr(), scale.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            partial.data_ptr(), rows, d, int(dy.dtype == torch.bfloat16),
            stream)
    kernels.check(code, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


def ln_backward(xhat, rstd, scale, dy):
    """The LayerNorm backward of the device the tensors lie on: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if dy.is_cuda:
        dx, dscale, dbias = layer_norm_bwd(xhat, rstd, scale.float(), dy)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)
    return ln_bwd_reference(xhat, rstd, scale, dy)


class _LayerNormLP(torch.autograd.Function):
    """Saves xhat in the operand dtype, rstd and the scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, xhat, rstd = _ln_lp_fwd(x, scale, bias, eps)
        ctx.save_for_backward(xhat, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dscale, dbias = ln_backward(*ctx.saved_tensors, dy)
        return dx, dscale, dbias, None


def layer_norm_lp(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last dimension with the low-precision-residual
    backward (see the module docstring); differentiable in x, weight and
    bias."""
    return _LayerNormLP.apply(x, weight, bias, eps)


class LayerNormLP(nn.LayerNorm):
    """:class:`LayerNorm`'s parameters and state_dict keys, normalising with
    :func:`layer_norm_lp`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_lp(x, self.weight, self.bias, self.eps)
