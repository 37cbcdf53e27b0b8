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
(:func:`layer_norm_bwd`: ONE launch of 16-byte loads, all arithmetic f32,
f32 and bf16 operands, any number of rows and any width; row blocks write
dx, column blocks of the same launch take dscale and dbias slab by slab and
join through a thread-block cluster's shared memory, in a fixed order),
for CPU tensors the plain :func:`ln_bwd_reference`. Nothing else chooses the
path. Both take a second operand form, the raw x with ``mean`` and rstd,
for a caller that has no xhat in memory (the LayerNorm-fused attention's
backward); :func:`layer_norm_lp`'s own backward keeps the saved xhat. The
kernel refuses f64; :func:`layer_norm_lp` hands f64 operands to
:func:`layer_norm` (the f64 rule, stated in ops/kernels.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dostransformer_tpu_torch.ops import kernels

LN_EPS = 1e-5  # torch nn.LayerNorm default
# constants of csrc/layernorm_bwd.cu: threads of a block, most blocks of a
# cluster, most column blocks of a launch (while a slab is split)
LN_BWD_THREADS, LN_BWD_CLUSTER, LN_BWD_COLUMN_BLOCKS = 256, 8, 132
# threads that share a row of a column slab; passes of rows a block keeps
# when a slab's rows are split over a cluster
LN_BWD_SLAB_THREADS, LN_BWD_PASSES_TO_SPLIT = 8, 8


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
                     scale: torch.Tensor, dy: torch.Tensor,
                     mean: torch.Tensor | None = None):
    """Plain xhat-form LayerNorm backward: xhat and dy [..., D] in the
    operand dtype, rstd [..., 1], scale [D] -> (dx in dy's dtype, dscale and
    dbias [D] in scale's dtype). The row and column sums accumulate in f32
    or wider over the operand-dtype products, as the JAX package's
    ``_ln_bwd_jnp`` does. With ``mean`` ([..., 1], rstd's dtype) the first
    argument is the raw x and ``xhat = (x - mean) * rstd`` is formed here,
    in f32 or wider, and rounded to the operand dtype."""
    f = torch.promote_types(dy.dtype, torch.float32)
    if mean is not None:
        xhat = ((xhat.to(f) - mean) * rstd).to(dy.dtype)
    d = xhat.shape[-1]
    g = dy * scale.to(dy.dtype)
    s1 = g.sum(-1, keepdim=True, dtype=f) / d
    s2 = (g * xhat).sum(-1, keepdim=True, dtype=f) / d
    dx = (rstd * (g.to(f) - s1 - xhat.to(f) * s2)).to(dy.dtype)
    lead = tuple(range(dy.dim() - 1))
    dscale = (dy * xhat).sum(lead, dtype=f).to(scale.dtype)
    dbias = dy.sum(lead, dtype=f).to(scale.dtype)
    return dx, dscale, dbias


def ln_bwd_plan(rows: int, d: int, bf16: bool = False) -> dict:
    """The kernel's partition of ``rows`` rows of width ``d``, a function of
    (rows, d, dtype) alone (a copy of ``make_plan`` in
    ``csrc/layernorm_bwd.cu``; the card run holds the two equal). Row
    blocks take 8 rows each, a warp a row. The column sums are taken per
    slab of ``slab`` columns by ``cluster`` blocks that own
    ``rows_per_rank`` rows each: ``threads_a_row`` threads share a row of
    the slab (``vector`` elements each), a thread adds its rows (every
    ``rows_a_pass``-th) in order, then lanes, warps and blocks are added in
    fixed orders. ``grid`` is the blocks of the launch."""
    vec = 8 if bf16 else 4
    chunks = next((n for n in (1, 2, 4, 8) if d <= 32 * vec * n), 0)
    if d % vec:
        chunks = 0
    v = vec if chunks else 1
    slab = LN_BWD_SLAB_THREADS * v
    rows_a_pass = LN_BWD_THREADS // LN_BWD_SLAB_THREADS
    slabs = -(-d // slab)
    cluster = 1
    while (cluster < LN_BWD_CLUSTER
           and slabs * 2 * cluster <= LN_BWD_COLUMN_BLOCKS
           and rows > LN_BWD_PASSES_TO_SPLIT * rows_a_pass * cluster):
        cluster *= 2
    blocks = slabs * cluster + -(-rows // (LN_BWD_THREADS // 32))
    return {"vector_form": bool(chunks), "vector": v, "slab": slab,
            "threads_a_row": slab // v, "rows_a_pass": rows_a_pass,
            "slabs": slabs, "cluster": cluster,
            "rows_per_rank": -(-rows // cluster),
            "grid": -(-blocks // cluster) * cluster}


def layer_norm_bwd(xhat: torch.Tensor, rstd: torch.Tensor,
                   scale: torch.Tensor, dy: torch.Tensor,
                   mean: torch.Tensor | None = None):
    """The backward kernel (``csrc/layernorm_bwd.cu``, one launch): same
    contract as :func:`ln_bwd_reference`, both operand forms, with
    g = dy * scale kept in f32. CUDA tensors only: xhat (or x) and dy
    float32 or bfloat16 (one dtype), rstd, mean and scale float32, any
    width >= 1; anything else raises. The leading
    dimensions are flattened to rows, any count >= 1.
    ``layer_norm_bwd.launches`` counts kernel launches."""
    if not dy.is_cuda:
        raise ValueError("layer_norm_bwd: the kernel takes CUDA tensors; use "
                         "ln_bwd_reference on the CPU")
    if dy.dtype not in kernels.KERNEL_DTYPES:
        raise TypeError(f"layer_norm_bwd: dy is {dy.dtype}, the kernel takes "
                        f"float32 or bfloat16")
    d = dy.shape[-1]
    rows = dy.numel() // d if d else 0
    if rows < 1:
        raise ValueError("layer_norm_bwd: no rows")
    dy, xhat = dy.contiguous(), xhat.contiguous()
    for arg, t in (("rstd", rstd), ("mean", mean)):
        if t is not None and t.numel() != rows:
            raise ValueError(f"layer_norm_bwd: {arg} has {t.numel()} "
                             f"elements, expected one for each of the "
                             f"{rows} rows")
    rstd = rstd.reshape(rows)
    operands = {"xhat": (xhat, dy.dtype, dy.shape), "dy": (dy, dy.dtype,
                dy.shape), "rstd": (rstd, torch.float32, (rows,)),
                "scale": (scale, torch.float32, (d,))}
    if mean is not None:
        mean = mean.reshape(rows)
        operands["mean"] = (mean, torch.float32, (rows,))
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("layer_norm_bwd", arg, t, device=dy.device,
                        dtype=dtype, shape=shape)
    dx = torch.empty_like(dy)
    dscale = torch.empty(d, device=dy.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    kernels.launch("layer_norm_bwd", "dostpu_layer_norm_bwd", xhat, mean,
                   rstd, dy, scale, dx, dscale, dbias, rows, d,
                   int(dy.dtype == torch.bfloat16))
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


def ln_backward(xhat, rstd, scale, dy, mean=None):
    """The LayerNorm backward of the device the tensors lie on: the kernel
    for CUDA tensors, the plain version for CPU tensors. With ``mean`` the
    first argument is the raw x (see :func:`ln_bwd_reference`)."""
    if dy.is_cuda:
        dx, dscale, dbias = layer_norm_bwd(xhat, rstd, scale.float(), dy,
                                           mean)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)
    return ln_bwd_reference(xhat, rstd, scale, dy, mean)


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
