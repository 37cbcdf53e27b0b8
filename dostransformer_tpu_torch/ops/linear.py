"""The model's linears: ``x W^T (+ b)`` over the rows of x [..., K], with
W [N, K] (a parameter, or a column slice of one: the processors'
``w0[:, :h]``, the parts form's ``weight[:, off:off + k]``; read through
its row stride, not copied). In the JAX package XLA runs them (flax
Dense); no Pallas kernel stands behind them.

:func:`linear` is the op every linear of the model but the FFN on #8 calls.
It picks from its operands: bf16 rounds the product before the bias, as
the JAX package does; f64 takes ``F.linear`` (the f64 rule,
``ops/kernels.py takes_kernels``); f32 takes :func:`linear_op` where
:func:`linear_plan` says so (a pure function of the rows, the widths and
the dtype; see its docstring for the measurements), else ``F.linear``.

:func:`linear_op` is the kernel op: CPU tensors run ``F.linear`` itself
(autograd through it, so the CPU's bits are today's); CUDA tensors run
kernel #9, ``csrc/linear.cu`` (f32 only; anything else raises): the
forward through :func:`linear_fwd_op`, the ``dostpu::linear_fwd`` custom
op (graph capture and ``torch.export`` see one node), the backward through
:func:`linear_bwd_kernel` (dX, dW, db, each only where autograd asks for
it). Nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dostransformer_tpu_torch import tracing
from dostransformer_tpu_torch.ops import kernels

# the fewest rows that take #9: measured on the H100 (see linear_plan)
MIN_ROWS = 3072
# the narrowest K and N that take #9: a 32-deep chunk and a quarter of the
# 128-wide tile (narrower products are a few multiply-adds a row)
MIN_WIDTH = 32


def linear_plan(rows: int, k: int, n: int, dtype: torch.dtype) -> bool:
    """True where :func:`linear` sends an f32 linear of ``rows`` rows,
    ``k`` inputs and ``n`` outputs to :func:`linear_op`: f32 operands, K
    and N multiples of 4 (the 16-byte row strides of the kernel's TMA maps
    of x and dY) and at least ``MIN_WIDTH``, and at least ``MIN_ROWS``
    rows. bf16 (``F.linear``
    then ``+ bias``, the JAX package's rounding), f64 (the plain functions),
    the eDOS edge encoder's K = 41, phDOS's 118 and 4, the heads' N = 1
    and fewer rows keep ``F.linear``.

    The threshold, timed on an NVIDIA H100 80GB HBM3 at 700 W (device ms
    by CUDA events, median of 30; #9 against F.linear by cuBLAS in f32,
    forward, then forward and backward, cuBLAS's backward as the mm, mm
    and sum autograd runs): K = 256 -> N = 512 with bias (the edge
    projection, its weight a slice), 1,024 rows 0.0194 against 0.0150 and
    0.0603 against 0.0558 (cuBLAS faster), 2,048 rows 0.0196 against 0.0219
    and 0.0645 against 0.0752, 3,072 rows 0.0199 against 0.0301 and 0.0690
    against 0.0981; K = 512 -> 256 (node_mlp_2's second linear), 2,048
    rows 0.0280 against 0.0233 forward (cuBLAS faster) and 0.0645 against
    0.0726, 3,072 rows 0.0283 against 0.0350 and 0.0696 against 0.1019;
    K = 256 -> 256, 2,048 rows 0.0194 against 0.0151 and 0.0532 against
    0.0544, 3,072 rows 0.0195 against 0.0217 and 0.0552 against 0.0697;
    K = 200 -> 256 (the node encoder), 3,072 rows 0.0184 against 0.0174
    and 0.0533 against 0.0636, 8,192 rows 0.0204 against 0.0274. A call
    costs #9 about 11 us and 1.1 us a 32-deep chunk of K however few its
    rows (a unit's chunks run in turn on one SM), so from 3,072 rows #9 is faster both ways at every width
    of the cell but K = 200's forward (within 6%); at the cell's largest
    call (180,224 rows, 256 -> 512) 0.462 against 1.043 forward and 1.49
    against 3.26 with autograd's backward (95 against 41 TFLOP/s). So the
    cell's edge products, its node products from atom bucket 64 (4,096
    rows) and its heads (12,864 rows) take #9; bucket 8-32's node products
    (512-2,048 rows), the global encoder and the decoder (64 rows) keep
    cuBLAS."""
    return (dtype == torch.float32 and k % 4 == 0 and n % 4 == 0
            and min(k, n) >= MIN_WIDTH and rows >= MIN_ROWS)


def _weight_stride(name: str, x: torch.Tensor, weight: torch.Tensor) -> int:
    """Check what the kernels' C entries assume of the weight: f32 [N, K]
    on x's device with unit column stride; return its row stride."""
    if weight.device != x.device:
        raise ValueError(f"{name}: weight is on {weight.device}, expected "
                         f"{x.device}")
    if weight.dtype != torch.float32:
        raise TypeError(f"{name}: weight is {weight.dtype}, the kernel "
                        f"takes torch.float32")
    if weight.dim() != 2 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: weight has shape {tuple(weight.shape)}, "
                         f"expected (N, {x.shape[1]})")
    if weight.stride(1) != 1 or weight.stride(0) < weight.shape[1]:
        raise ValueError(f"{name}: weight must have unit column stride")
    return weight.stride(0)


def _require(name, x, weight, **more) -> int:
    """x [M, K] f32, contiguous, 16-byte aligned; K and N multiples of 4;
    ``more`` (name -> (tensor, shape)) likewise. Returns the weight's row
    stride."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                         f"(M, K)")
    m, k = x.shape
    n = weight.shape[0]
    if k % 4 or n % 4:
        raise ValueError(f"{name}: K = {k} and N = {n} must be multiples "
                         f"of 4")
    if m == 0:
        raise ValueError(f"{name}: no rows")
    ldw = _weight_stride(name, x, weight)
    for arg, (t, shape) in {"x": (x, (m, k)), **more}.items():
        kernels.require(name, arg, t, device=x.device, dtype=torch.float32,
                        shape=shape)
    return ldw


def linear_fwd_kernel(x, weight, bias):
    """The forward kernels on CUDA tensors: x [M, K] @ weight^T (+ bias),
    [M, N]. Counted in ``linear_op.launches``."""
    if not x.is_cuda:
        raise ValueError("linear_fwd_kernel: the kernel takes CUDA tensors; "
                         "use F.linear on the CPU")
    m, n = x.shape[0], weight.shape[0]
    more = {} if bias is None else {"bias": (bias, (n,))}
    ldw = _require("linear", x, weight, **more)
    y = x.new_empty((m, n))
    k = x.shape[1]
    scratch = x.new_empty(
        (kernels.library().dostpu_linear_scratch_floats(m, n, k, 0),))
    kernels.launch("linear", "dostpu_linear_fwd", x, weight, ldw, bias, y,
                   scratch, m, n, k)
    linear_op.launches += 1
    return y


def linear_bwd_kernel(x, weight, gy, need_x=True, need_w=True,
                      need_b=True):
    """The backward kernels on CUDA tensors: (gx, gw, gb) from the
    forward's x [M, K] and weight and the upstream gradient gy [M, N]; each
    None where it is not needed (gb needs the dW pass, so ``need_b`` alone
    runs it). Counted in ``linear_bwd_kernel.launches``."""
    if not x.is_cuda:
        raise ValueError("linear_bwd_kernel: the kernel takes CUDA tensors")
    gy = gy.contiguous()
    m, k = x.shape
    n = weight.shape[0]
    ldw = _require("linear_bwd", x, weight, gy=(gy, (m, n)))
    gx = torch.empty_like(x) if need_x else None
    dw = need_w or need_b
    gw = x.new_empty((n, k)) if dw else None
    gb = x.new_empty((n,)) if need_b else None
    if gx is None and gw is None:
        return None, None, None
    scratch = x.new_empty(
        (kernels.library().dostpu_linear_scratch_floats(m, n, k, 1),))
    kernels.launch("linear_bwd", "dostpu_linear_bwd", x, weight, ldw, gy, gx,
                   gw, gb, scratch, m, n, k)
    linear_bwd_kernel.launches += 1
    return gx, gw if need_w else None, gb


linear_bwd_kernel.launches = 0


@torch.library.custom_op("dostpu::linear_fwd", mutates_args=(),
                         device_types="cuda")
def linear_fwd_op(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward as one opaque op (``torch.ops.dostpu.linear_fwd``) on x
    [M, K]: CUDA tensors launch the kernels (:func:`linear_fwd_kernel`),
    CPU tensors (an artifact exported on the card, run on the CPU)
    ``F.linear``."""
    return linear_fwd_kernel(x, weight, bias)


@linear_fwd_op.register_kernel("cpu")
def _(x, weight, bias):
    return F.linear(x, weight, bias)


@linear_fwd_op.register_fake
def _(x, weight, bias):
    return x.new_empty((x.shape[0], weight.shape[0]))


class _Linear(torch.autograd.Function):
    """Forward through :func:`linear_fwd_op`, backward through
    :func:`linear_bwd_kernel`; saves x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return linear_fwd_op(x, weight, bias)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        return linear_bwd_kernel(x, weight, gy, need_x, need_w, need_b)


def linear_op(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` for x [..., K], differentiable in
    every argument. CPU tensors run ``F.linear`` itself; CUDA tensors the
    kernel (f32; K and N multiples of 4; anything else raises).
    ``linear_op.launches`` counts forward kernel launches."""
    if not x.is_cuda:
        return F.linear(x, weight, bias)
    k = x.shape[-1]
    y = _Linear.apply(x.reshape(-1, k).contiguous(), weight, bias)
    return y.reshape(*x.shape[:-1], weight.shape[0])


linear_op.launches = 0


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ weight^T + bias with the parameters cast to x's dtype. In bf16
    the product is rounded before the bias is added, as the JAX package
    rounds it (``y = x @ k; y + b``); a fused call would round once. f32
    keeps the one fused call (the two differ by an f32 rounding): kernel #9
    where :func:`linear_plan` says so (:func:`linear_op`: ``F.linear``
    itself on the CPU), else ``F.linear``; f64 takes ``F.linear``.
    ``weight`` may be a column slice of a parameter. ``tracing`` counts
    every call's rows (``linear.rows``) and the rows that took #9 on the
    card (``linear.kernel_rows``)."""
    weight = weight.to(x.dtype)
    k = weight.shape[1]
    rows = x.numel() // k
    tracing.count("linear.rows", rows)
    if x.dtype == torch.bfloat16:
        y = F.linear(x, weight)
        return y if bias is None else y + bias.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if linear_plan(rows, k, weight.shape[0], x.dtype):
        if x.is_cuda:
            tracing.count("linear.kernel_rows", rows)
        return linear_op(x, weight, bias)
    return F.linear(x, weight, bias)
