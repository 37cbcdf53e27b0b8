"""LayerNorm with f32 statistics, and its low-precision-residual variant.

Counterpart of dostransformer_tpu/nn/layernorm.py.

:class:`LayerNorm` is the default path: it normalises with the op
:func:`~dostransformer_tpu_torch.ops.layernorm.layer_norm` (statistics in
float32 or wider whatever the operand dtype, the output cast back to the
operand dtype; kernels #10 and #7 on the card, ``F.layer_norm`` on the CPU
and for f64).

:func:`layer_norm_lp` / :class:`LayerNormLP` are the counterpart of the JAX
package's ``layer_norm_lp``: the same forward written out (f32 statistics
with the fast variance ``E[x^2] - E[x]^2`` clamped at 0, scale and bias
applied in f32, output cast to the operand dtype), and a backward of its
own that keeps xhat **in the operand dtype** (bf16 under bf16 operands),
rstd in f32, and computes

    dx     = rstd * (g - mean_d(g) - xhat * mean_d(g * xhat)),  g = dy * scale
    dscale = sum_leading(dy * xhat)
    dbias  = sum_leading(dy)

For CUDA tensors the backward is kernel #7 (``csrc/layernorm_bwd.cu``,
:func:`~dostransformer_tpu_torch.ops.layernorm.layer_norm_bwd`), for CPU
tensors the plain ``ln_bwd_reference``, both through ``ln_backward``.
Nothing else chooses the path. The kernel refuses f64;
:func:`layer_norm_lp` hands f64 operands to :func:`layer_norm` (the f64
rule, stated in ops/kernels.py).
"""

from __future__ import annotations

import torch
from torch import nn

from dostransformer_tpu_torch.ops import kernels
from dostransformer_tpu_torch.ops.layernorm import (
    LN_EPS,
    layer_norm,
    ln_backward,
)


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
    bias. Operands the kernel does not take (f64) go to :func:`layer_norm`
    on every device (the f64 rule, stated in ops/kernels.py)."""
    if x.dtype not in kernels.KERNEL_DTYPES:
        return layer_norm(x, weight, bias, eps)
    return _LayerNormLP.apply(x, weight, bias, eps)


class LayerNormLP(nn.LayerNorm):
    """:class:`LayerNorm`'s parameters and state_dict keys, normalising with
    :func:`layer_norm_lp`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_lp(x, self.weight, self.bias, self.eps)
