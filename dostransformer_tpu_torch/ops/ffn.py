"""The transformer layer's FFN: kernel #8 on the card, and its plain version.

``relu(x W1^T + b1) W2^T + b2`` over the rows of x [..., D], with W1
[4D, D] and W2 [D, 4D] (the layer's fc1 and fc2). In the JAX package XLA
runs it; no Pallas kernel stands behind it. :func:`ffn_reference` is the
plain version, today's composition exactly (``F.linear``, ``F.relu``,
``F.linear``); :func:`ffn_bwd_reference` the backward's, from the forward's
H. :func:`ffn` is the op: CPU tensors run the plain version
itself (autograd through it, so the CPU's bits are the plain
composition's); CUDA tensors run ``csrc/ffn.cu`` (f32 only; anything else
raises): the forward through :func:`ffn_fwd_op`, the ``dostpu::ffn_fwd``
custom op (graph capture and ``torch.export`` see one node), the backward
through the backward kernels (dX, dW1, db1, dW2, db2 from the forward's x
and H). Nothing falls back.

:func:`ffn_plan` says where the layer takes the op: a pure function of the
rows, the width and the dtype (see its docstring for the measurements).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dostransformer_tpu_torch.ops import kernels

# the fewest rows that take #8: measured on the H100 (see ffn_plan)
MIN_ROWS = 1224


def ffn_plan(rows: int, d: int, dtype: torch.dtype) -> bool:
    """True where the layer's FFN at ``rows`` rows of width ``d`` and
    operand ``dtype`` goes to :func:`ffn`: f32 operands, d a multiple of
    32 (the kernel's K chunks; hidden 256 and 1,024 among them), and at
    least ``MIN_ROWS`` rows. bf16 (ROADMAP item 4), f64 (the plain
    functions), widths such as phDOS's hidden 50, and fewer rows keep
    today's path. The layer adds its own conditions: no tensor-parallel
    split, no ReLU dropout mask in the call.

    The threshold, timed on an NVIDIA H100 80GB HBM3 at 700 W (device ms,
    #8 against F.linear, F.relu, F.linear by cuBLAS in f32; forward, then
    forward and backward): at D = 256, 1,024 rows 0.0623 against 0.0533
    and 0.1733 against 0.1678 (cuBLAS faster), 1,224 rows 0.0625 against
    0.0710 and 0.1772 against 0.1995 (#8 faster), 3,264 rows (phDOS at
    hidden 256, batch 64) 0.0753 against 0.1237 and 0.2376 against 0.3660,
    12,864 (the eDOS cell's cross stack) 0.59 against 1.19 forward and
    backward; at D = 1,024, 408 rows 0.2656 against 0.2594 and 0.6711
    against 0.6389, 816 rows 0.3077 against 0.4222 and 0.8467 against
    1.0925. So f32 serving takes #8 from eDOS batch 7 (1,407 rows) and
    phDOS batch 24 (1,224 rows) at hidden 256, every eDOS training step at
    batch 8 or more."""
    return dtype == torch.float32 and d % 32 == 0 and rows >= MIN_ROWS


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain version: the layer's composition before #8, bit for bit
    (f32: ``F.linear`` by cuBLAS on the card, not #9)."""
    return F.linear(F.relu(F.linear(x, w1, b1)), w2, b2)


def ffn_bwd_reference(x, h, w1, w2, gy):
    """The plain backward for x [M, D], the forward's h = relu(x W1^T + b1)
    [M, 4D] and gy [M, D]: (gx, gw1, gb1, gw2, gb2), ReLU's mask read from
    h as the kernel reads it (on the card this is its comparison on the
    same side of 0: the products' rounding can put an input on either
    side, and fc1's gradients then differ by that input's whole term)."""
    gh = torch.where(h > 0, gy @ w2, 0.0)
    return gh @ w1, gh.T @ x, gh.sum(0), gy.T @ h, gy.sum(0)


def _require(name, x, w1, w2, **more):
    """What the kernels' C entries assume: x [M, D] and the weights (and
    ``more``: name -> (tensor, shape)) f32, contiguous, on x's device; D a
    multiple of 32."""
    m, d = x.shape
    if d % 32:
        raise ValueError(f"{name}: width {d} is not a multiple of 32")
    operands = {"x": (x, (m, d)), "w1": (w1, (4 * d, d)),
                "w2": (w2, (d, 4 * d)), **more}
    for arg, (t, shape) in operands.items():
        kernels.require(name, arg, t, device=x.device, dtype=torch.float32,
                        shape=shape)


def ffn_fwd_kernel(x, w1, b1, w2, b2):
    """The forward kernels on CUDA tensors: returns (y, h), h = relu(x W1^T
    + b1) [M, 4D] kept for the backward. x [M, D] and the parameters f32,
    contiguous; D a multiple of 32. Counted in ``ffn.launches``."""
    if not x.is_cuda:
        raise ValueError("ffn_fwd_kernel: the kernel takes CUDA tensors; "
                         "use ffn_reference on the CPU")
    m, d = x.shape
    _require("ffn", x, w1, w2, b1=(b1, (4 * d,)), b2=(b2, (d,)))
    h = x.new_empty((m, 4 * d))
    y = torch.empty_like(x)
    lib = kernels.library()
    scratch = x.new_empty((lib.dostpu_ffn_scratch_floats(m, d, 0),))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_ffn_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                  w2.data_ptr(), b2.data_ptr(), h.data_ptr(),
                                  y.data_ptr(), scratch.data_ptr(), m, d,
                                  stream)
    kernels.check(code, "ffn")
    ffn.launches += 1
    return y, h


def ffn_bwd_kernel(x, h, w1, w2, gy):
    """The backward kernels on CUDA tensors: (gx, gw1, gb1, gw2, gb2) from
    the forward's x [M, D] and h [M, 4D] and the upstream gradient gy
    [M, D]. Counted in ``ffn_bwd_kernel.launches``."""
    if not x.is_cuda:
        raise ValueError("ffn_bwd_kernel: the kernel takes CUDA tensors")
    gy = gy.contiguous()
    m, d = x.shape
    _require("ffn_bwd", x, w1, w2, h=(h, (m, 4 * d)), gy=(gy, (m, d)))
    gx = torch.empty_like(x)
    gw1, gw2 = torch.empty_like(w1), torch.empty_like(w2)
    gb1, gb2 = w1.new_empty(4 * d), w2.new_empty(d)
    lib = kernels.library()
    scratch = x.new_empty((lib.dostpu_ffn_scratch_floats(m, d, 1),))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_ffn_bwd(x.data_ptr(), h.data_ptr(), w1.data_ptr(),
                                  w2.data_ptr(), gy.data_ptr(), gx.data_ptr(),
                                  gw1.data_ptr(), gb1.data_ptr(),
                                  gw2.data_ptr(), gb2.data_ptr(),
                                  scratch.data_ptr(), m, d, stream)
    kernels.check(code, "ffn_bwd")
    ffn_bwd_kernel.launches += 1
    return gx, gw1, gb1, gw2, gb2


ffn_bwd_kernel.launches = 0


@torch.library.custom_op("dostpu::ffn_fwd", mutates_args=(),
                         device_types="cuda")
def ffn_fwd_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one opaque op (``torch.ops.dostpu.ffn_fwd``) on x
    [M, D]: CUDA tensors launch the kernels (:func:`ffn_fwd_kernel`), CPU
    tensors (an artifact exported on the card, run on the CPU) the plain
    version. Returns (y, h)."""
    return ffn_fwd_kernel(x, w1, b1, w2, b2)


@ffn_fwd_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2):
    h = F.relu(F.linear(x, w1, b1))
    return F.linear(h, w2, b2), h


@ffn_fwd_op.register_fake
def _(x, w1, b1, w2, b2):
    return torch.empty_like(x), x.new_empty((x.shape[0], w1.shape[0]))


class _FFN(torch.autograd.Function):
    """Forward through :func:`ffn_fwd_op`, backward through
    :func:`ffn_bwd_kernel`; saves x, H and the weights."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, h = ffn_fwd_op(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, h, w1, w2)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, h, w1, w2 = ctx.saved_tensors
        return ffn_bwd_kernel(x, h, w1, w2, gy)


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`ffn_reference` for x [..., D], differentiable
    in every argument. CPU tensors run the plain version; CUDA tensors the
    kernel (f32, D a multiple of 32, parameters contiguous; anything else
    raises). ``ffn.launches`` counts forward kernel launches."""
    if not x.is_cuda:
        return ffn_reference(x, w1, b1, w2, b2)
    d = x.shape[-1]
    y = _FFN.apply(x.reshape(-1, d).contiguous(), w1, b1, w2, b2)
    return y.reshape(x.shape)


ffn.launches = 0
