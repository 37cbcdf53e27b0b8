"""The model's LayerNorm over the last dimension: kernels #10 (forward) and
#7 (backward) on the card, and their plain versions.

Counterpart of the JAX package's default ``layer_norm``
(dostransformer_tpu/nn/layernorm.py): statistics in float32 or wider
whatever the operand dtype, scale and bias applied in that width, the
output cast back to the operand dtype.

:func:`layer_norm` is the op every default LayerNorm of the model calls
(nn/layernorm.py ``LayerNorm``, the transformer's ``layer_norms`` and final
LayerNorm, the MLP blocks' LayerNorm). It picks from its operands: CUDA
tensors of f32 or bf16 take the kernels, everything else (CPU tensors, f64
operands on every device: the f64 rule, ``ops/kernels.py takes_kernels``)
``F.layer_norm`` on the widened operands, with PyTorch's own backward,
exactly as before the kernels. On the card the forward is
:func:`layer_norm_fwd_op`, the ``dostpu::layer_norm_fwd`` custom op (graph
capture and ``torch.export`` see one node) that launches
``csrc/layernorm_fwd.cu`` (#10: y, and each row's mean and rstd in f32);
the backward is ``csrc/layernorm_bwd.cu`` (#7, one launch for dx, dscale
and dbias) on the raw x with that mean and rstd, xhat formed in f32. So a
bf16 LayerNorm rounds y once and dx once, as the widened ``F.layer_norm``
and its autograd do. The op saves x, mean and rstd, the residuals ATen's
LayerNorm keeps.

#7's wrapper (:func:`layer_norm_bwd`) also serves the two LayerNorm levers:
``layer_norm_lp``'s backward on its saved xhat (nn/layernorm.py) and the
LN-fused attention's backward on the raw inputs (ops/attention.py), both
through :func:`ln_backward`; their raw-x xhat is rounded to the operand
dtype, as the JAX package's ``_ln_bwd_jnp`` rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dostransformer_tpu_torch import tracing
from dostransformer_tpu_torch.ops import kernels

LN_EPS = 1e-5  # torch nn.LayerNorm default
# constants of csrc/layernorm_bwd.cu: threads of a block, most blocks of a
# cluster, most column blocks of a launch (while a slab is split)
LN_BWD_THREADS, LN_BWD_CLUSTER, LN_BWD_COLUMN_BLOCKS = 256, 8, 132
# threads that share a row of a column slab; passes of rows a block keeps
# when a slab's rows are split over a cluster
LN_BWD_SLAB_THREADS, LN_BWD_PASSES_TO_SPLIT = 8, 8


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = LN_EPS):
    """The plain forward with its statistics: x [..., D] -> (y in x's
    dtype, mean and rstd [...] in f32 or wider). y is the widened
    ``F.layer_norm`` cast back; mean and the biased variance are
    ``torch.var_mean``'s, rstd = rsqrt(var + eps)."""
    f = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f)
    var, mean = torch.var_mean(xf, -1, correction=0)
    y = F.layer_norm(xf, x.shape[-1:], scale.to(f), bias.to(f), eps)
    return y.to(x.dtype), mean, torch.rsqrt(var + eps)


def layer_norm_fwd_kernel(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = LN_EPS):
    """The forward kernel (#10, ``csrc/layernorm_fwd.cu``, one launch) on
    CUDA tensors: x [rows, D] float32 or bfloat16, scale and bias [D]
    float32, any rows >= 1 and width >= 1 -> (y [rows, D] in x's dtype,
    mean and rstd [rows] float32); anything else raises. Counted in
    ``layer_norm.launches``."""
    if not x.is_cuda:
        raise ValueError("layer_norm_fwd_kernel: the kernel takes CUDA "
                         "tensors; use layer_norm_reference on the CPU")
    if x.dtype not in kernels.KERNEL_DTYPES:
        raise TypeError(f"layer_norm_fwd_kernel: x is {x.dtype}, the kernel "
                        f"takes float32 or bfloat16")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"layer_norm_fwd_kernel: x has shape "
                         f"{tuple(x.shape)}, expected (rows >= 1, D >= 1)")
    rows, d = x.shape
    kernels.require("layer_norm_fwd", "x", x, device=x.device,
                    dtype=x.dtype, shape=(rows, d))
    for arg, t in (("scale", scale), ("bias", bias)):
        kernels.require("layer_norm_fwd", arg, t, device=x.device,
                        dtype=torch.float32, shape=(d,))
    y = torch.empty_like(x)
    mean = x.new_empty(rows, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    kernels.launch("layer_norm_fwd", "dostpu_layer_norm_fwd", x, scale, bias,
                   y, mean, rstd, rows, d, float(eps),
                   int(x.dtype == torch.bfloat16))
    layer_norm.launches += 1
    return y, mean, rstd


@torch.library.custom_op("dostpu::layer_norm_fwd", mutates_args=(),
                         device_types="cuda")
def layer_norm_fwd_op(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward as one opaque op (``torch.ops.dostpu.layer_norm_fwd``)
    on x [rows, D]: CUDA tensors launch #10 (:func:`layer_norm_fwd_kernel`),
    CPU tensors (an artifact exported on the card, run on the CPU) the
    plain version. Returns (y, mean, rstd)."""
    return layer_norm_fwd_kernel(x, scale, bias, eps)


@layer_norm_fwd_op.register_kernel("cpu")
def _(x, scale, bias, eps):
    return layer_norm_reference(x, scale, bias, eps)


@layer_norm_fwd_op.register_fake
def _(x, scale, bias, eps):
    mean = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return torch.empty_like(x), mean, torch.empty_like(mean)


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
                   mean: torch.Tensor | None = None, wide: bool = False):
    """The backward kernel (#7, ``csrc/layernorm_bwd.cu``, one launch):
    same contract as :func:`ln_bwd_reference`, both operand forms, with
    g = dy * scale kept in f32; with ``wide`` the raw form keeps xhat in
    f32 (the default LayerNorm's backward) instead of rounding it to the
    operand dtype. CUDA tensors only: xhat (or x) and dy float32 or
    bfloat16 (one dtype), rstd, mean and scale float32, any width >= 1;
    anything else raises. The leading dimensions are flattened to rows,
    any count >= 1. ``layer_norm_bwd.launches`` counts kernel launches."""
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
                   int(dy.dtype == torch.bfloat16), int(wide))
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


def ln_backward(xhat, rstd, scale, dy, mean=None):
    """The levers' LayerNorm backward on the device the tensors lie on: #7
    for CUDA tensors, the plain version for CPU tensors. With ``mean`` the
    first argument is the raw x (see :func:`ln_bwd_reference`)."""
    if dy.is_cuda:
        dx, dscale, dbias = layer_norm_bwd(xhat, rstd, scale.float(), dy,
                                           mean)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype)
    return ln_bwd_reference(xhat, rstd, scale, dy, mean)


class _LayerNorm(torch.autograd.Function):
    """Forward through :func:`layer_norm_fwd_op`, backward through
    :func:`layer_norm_bwd` on the raw x (xhat in f32); saves x, mean, rstd
    and the scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd_op(x, scale, bias, eps)
        ctx.save_for_backward(x, mean, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, rstd, scale, dy, mean,
                                           wide=True)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm of x [..., D] over its last dimension, differentiable in
    x, weight and bias: #10 and #7 for f32 and bf16 CUDA tensors, the
    widened ``F.layer_norm`` cast back elsewhere (see the module
    docstring). ``tracing`` counts every call's rows (``layer_norm.rows``)
    and the rows that took the kernels (``layer_norm.kernel_rows``);
    ``layer_norm.launches`` counts #10's launches."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    tracing.count("layer_norm.rows", rows)
    f = torch.promote_types(x.dtype, torch.float32)
    if not (rows and x.is_cuda and kernels.takes_kernels(x.dtype)):
        return F.layer_norm(x.to(f), x.shape[-1:], weight.to(f), bias.to(f),
                            eps).to(x.dtype)
    tracing.count("layer_norm.kernel_rows", rows)
    flat = x.reshape(rows, d).contiguous()
    # a view at an odd offset: the kernels load 16 bytes at a time (the
    # offset, not the pointer, so that torch.export's fake tensors pass)
    if flat.storage_offset() * flat.element_size() % 16:
        flat = flat.clone()
    y = _LayerNorm.apply(flat, weight.to(f), bias.to(f), eps)
    return y.reshape(x.shape)


layer_norm.launches = 0
