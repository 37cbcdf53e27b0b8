"""Fused message-passing edge pipeline: CUDA kernel and its plain version.

Counterpart of dostransformer_tpu/ops/fused_mp.py. One GNN processor step's
edge pipeline:

    mid   = src_proj[senders] + dst_proj[receivers] + edge_proj   (gathers)
    act   = PReLU(LayerNorm(mid))
    e_out = act @ W1^T + b1                                       (edge MLP tail)
    agg   = segment_sum(e_out * edge_mask -> receivers)           (scatter)

The node-level projections (src_proj = x @ W0[:, :H]^T, ...) stay with the
caller as plain matrix products. :func:`fused_mp_edge` is differentiable (a
``torch.autograd.Function``): for CUDA tensors its forward is the kernel in
``csrc/fused_mp.cu`` and its backward the kernel in ``csrc/fused_mp_bwd.cu``;
for CPU tensors they are :func:`mp_edge_reference` and
:func:`mp_edge_bwd_reference`. Nothing else chooses the path.

Layout: batch-leading, as in the JAX package, except that ``w1`` is torch's
Linear weight ``[H, M]`` (out, in) — the JAX functions take the flax kernel
``[M, H]``. The kernel reads it as it lies, so no transpose is copied per
call.

bf16 operands (a bf16 model): the forward takes src_proj, dst_proj and
edge_proj in bf16 and returns e_out and agg in bf16, with every other
operand (edge_mask, the LayerNorm's scale and bias, alpha, w1, b1) f32, as
the TPU kernel takes them. It rounds where that kernel rounds: mid, the
LayerNorm, PReLU and ``act @ W1^T + b1`` are f32; e_out is rounded once;
agg sums the unrounded f32 e_out and is rounded once. The plain version
rounds at the same two points. The backward (kernel and plain version)
takes the projections and the cotangents g_eout, g_agg in bf16, widens them
to f32 and returns all eight gradients in f32, as the TPU kernel does; the
autograd engine then casts the three projections' gradients to bf16, their
inputs' dtype (the JAX custom VJP hands them on in f32).

Each kernel has two hand-written forms, chosen by the widths alone
(:func:`fused_mp_form` for the forward, :func:`fused_mp_bwd_form` for the
backward): where M and H are multiples of 32 and a block of the kernel fits
in shared memory, the three matrix products run on the tensor cores (3xTF32,
f32-accurate); at every other width as FMA loops, whose blocks take the same
shared memory at every width, so every width has a form. ``form`` (a keyword of
the two kernel wrappers, for measurements and tests) overrides the choice
with ``FORM_GENERIC`` or ``FORM_TENSOR_CORE``.
"""

from __future__ import annotations

import ctypes

import torch

from dostransformer_tpu_torch.ops import kernels
from dostransformer_tpu_torch.ops.segment import segment_sum_reference

LN_EPS = 1e-5
FORM_BY_SHAPE, FORM_GENERIC, FORM_TENSOR_CORE = -1, 0, 1
SMEM_MAX = 227 * 1024  # bytes of shared memory a block may ask for (sm_90)


def _tc_widths(m: int, h: int) -> bool:
    return m > 0 and h > 0 and m % 32 == 0 and h % 32 == 0


def fused_mp_form(m: int, h: int) -> int:
    """Which form of the forward kernel the widths M and H take on the card:
    the mirror of ``dostpu_fused_mp_form`` in ``csrc/fused_mp.cu``. The
    tensor-core form's smallest block holds 16 rows of M + 4 floats and two
    staged [64 x 68] chunks of W1."""
    fits = 4 * (16 * (m + 4) + 2 * 64 * 68) <= SMEM_MAX
    return FORM_TENSOR_CORE if _tc_widths(m, h) and fits else FORM_GENERIC


def bwd_tc_smem_bytes(m: int, h: int, mt: int, cluster: int,
                      stages: int) -> int:
    """Shared memory of a block of the backward's tensor-core pass A: the
    mirror of ``tc_smem_bytes`` in ``csrc/fused_mp_bwd.cu``. 16 mt edges;
    xhat and g_act of the block's M / cluster columns, g_e [H + 4] and
    rstd a row; ``stages`` staged tiles of 32 rows of W1, 128 + 8 columns in
    a cluster of four, else 256 + 8."""
    te = 16 * mt
    stage = 32 * ((128 if cluster == 4 else 256) + 8)
    return 4 * (2 * te * (m // cluster) + te * (h + 4) + te + stages * stage)


def fwd_generic_smem_bytes() -> int:
    """Shared memory of a block of the forward's generic form, the same at
    every width: a [16 x 32] tile of act and a [256 x 32] chunk of W1 (rows
    of 33 floats), the mean and rstd of 16 rows; the mirror of
    ``kGenericSmemFloats`` in ``csrc/fused_mp.cu``."""
    return 4 * ((16 + 256) * 33 + 2 * 16)


def bwd_generic_smem_bytes() -> int:
    """Shared memory of a block of the backward's generic pass A, the same
    at every width: a [32 x 256] chunk of W1, a [16 x 32] chunk of g_e,
    three floats for each of 16 rows and one for each of 8 warps (xhat,
    g_e and g_act stay in device memory); the mirror of
    ``kEdgeSmemFloats`` in ``csrc/fused_mp_bwd.cu``."""
    return 4 * (32 * 256 + 16 * 32 + 3 * 16 + 8)


def _bwd_tc_shapes(m: int, h: int):
    """(edge tiles of 16, cluster) shapes of the tensor-core pass A that
    fit with two staged tiles: a cluster of 2 or 4 shares a tile of 16
    edges where M / cluster is at least one pass (256 columns, 128 in a
    cluster of four) of whole column blocks of its warps (32 a warp, 16 in
    a cluster of four)."""
    for mt in (2, 1):
        for cluster in (1, 2, 4):
            pass_cols = 128 if cluster == 4 else 256
            if cluster > 1 and (mt != 1 or m % (cluster * pass_cols // 8)
                                or m // cluster < pass_cols):
                continue
            if bwd_tc_smem_bytes(m, h, mt, cluster, 2) <= SMEM_MAX:
                yield mt, cluster


def fused_mp_bwd_form(m: int, h: int) -> int:
    """Which form of the backward kernel the widths take: the mirror of
    ``dostpu_fused_mp_bwd_form`` in ``csrc/fused_mp_bwd.cu``: the
    tensor-core form where M and H are multiples of 32 and some shape of its
    pass A fits (:func:`bwd_tc_smem_bytes`), else the generic form."""
    tc = _tc_widths(m, h) and any(_bwd_tc_shapes(m, h))
    return FORM_TENSOR_CORE if tc else FORM_GENERIC


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, F], idx [B, E] -> x[b, idx[b, e]] as [B, E, F]."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def mp_edge_reference(src_proj, dst_proj, edge_proj, senders, receivers,
                      edge_mask, ln_scale, ln_bias, alpha, w1, b1):
    """Plain PyTorch composition of the fused pipeline.

    src_proj/dst_proj [B, A, M], edge_proj [B, E, M], senders/receivers
    [B, E] int, edge_mask [B, E], ln_scale/ln_bias [M], alpha [1],
    w1 [H, M] (torch layout), b1 [H]; returns (e_out [B, E, H],
    agg [B, A, H]) in the projections' dtype. bf16 projections are widened
    to f32 first and everything is f32 up to e_out, which is rounded once;
    agg sums the unrounded e_out and is rounded once (the TPU kernel's
    rounding points, not those of the unfused composition)."""
    dtype = src_proj.dtype
    f = torch.promote_types(dtype, torch.float32)
    src_proj, dst_proj, edge_proj = (t.to(f) for t in (src_proj, dst_proj,
                                                        edge_proj))
    mid = (gather_rows(src_proj, senders) + gather_rows(dst_proj, receivers)
           + edge_proj)
    mu = mid.mean(-1, keepdim=True)
    var = ((mid - mu) ** 2).mean(-1, keepdim=True)
    norm = (mid - mu) * torch.rsqrt(var + LN_EPS) * ln_scale + ln_bias
    act = torch.clamp(norm, min=0.0) + alpha * torch.clamp(norm, max=0.0)
    e_out = torch.nn.functional.linear(act, w1.to(f), b1.to(f))
    agg = segment_sum_reference(e_out * edge_mask[..., None].to(f),
                                receivers, src_proj.shape[1])
    return e_out.to(dtype), agg.to(dtype)


def mp_edge_bwd_reference(src_proj, dst_proj, edge_proj, senders, receivers,
                          edge_mask, ln_scale, ln_bias, alpha, w1, g_eout,
                          g_agg):
    """Plain backward of :func:`mp_edge_reference`, a line-for-line
    counterpart of the JAX package's ``_bwd_kernel``: recompute the forward
    intermediates, then the gradients. g_eout [B, E, H], g_agg [B, A, H];
    returns (g_src_proj, g_dst_proj, g_edge_proj, g_ln_scale, g_ln_bias,
    g_alpha [1], g_w1 [H, M], g_b1 [H]). Every edge scatters its g_mid onto
    its sender and receiver, pad edges (mask 0) included; the mask only
    weighs the aggregation's gradient. bf16 operands are widened to f32:
    every gradient is f32, as the JAX ``_bwd_kernel``'s are."""
    a = src_proj.shape[1]
    f = torch.promote_types(src_proj.dtype, torch.float32)
    src_proj, dst_proj, edge_proj, g_eout, g_agg = (
        t.to(f) for t in (src_proj, dst_proj, edge_proj, g_eout, g_agg))
    mid = (gather_rows(src_proj, senders) + gather_rows(dst_proj, receivers)
           + edge_proj)
    mu = mid.mean(-1, keepdim=True)
    var = ((mid - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (mid - mu) * rstd
    norm = xhat * ln_scale + ln_bias
    act = torch.clamp(norm, min=0.0) + alpha * torch.clamp(norm, max=0.0)

    # d e_out: upstream + the aggregation's contribution (gather of g_agg)
    g_e = g_eout + edge_mask[..., None] * gather_rows(g_agg, receivers)
    # W1 tail
    g_w1 = torch.einsum("beh,bem->hm", g_e, act)
    g_b1 = g_e.sum((0, 1))
    g_act = g_e @ w1
    # PReLU: act = max(norm, 0) + alpha * min(norm, 0)
    pos = norm > 0.0
    g_norm = torch.where(pos, g_act, alpha * g_act)
    g_alpha = torch.where(pos, 0.0, g_act * norm).sum().reshape(1)
    # LayerNorm
    g_ln_scale = (g_norm * xhat).sum((0, 1))
    g_ln_bias = g_norm.sum((0, 1))
    g_xhat = g_norm * ln_scale
    g_mid = rstd * (g_xhat - g_xhat.mean(-1, keepdim=True)
                    - xhat * (g_xhat * xhat).mean(-1, keepdim=True))
    g_src = segment_sum_reference(g_mid, senders, a)
    g_dst = segment_sum_reference(g_mid, receivers, a)
    return g_src, g_dst, g_mid, g_ln_scale, g_ln_bias, g_alpha, g_w1, g_b1


def _require_all(kernel, operands, device):
    for arg, (t, dtype, shape) in operands.items():
        kernels.require(kernel, arg, t, device=device, dtype=dtype,
                        shape=shape)


def _check_smem(kernel, need, device):
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(f"{kernel}: these widths need {need} bytes of "
                         f"shared memory per block, the card allows {limit}")


def _check_form(kernel, form, m, h):
    """``form`` is one of the three constants, and a forced tensor-core
    form needs widths it can take."""
    if form not in (FORM_BY_SHAPE, FORM_GENERIC, FORM_TENSOR_CORE):
        raise ValueError(f"{kernel}: form {form} is none of FORM_BY_SHAPE, "
                         f"FORM_GENERIC, FORM_TENSOR_CORE")
    if form == FORM_TENSOR_CORE and not _tc_widths(m, h):
        raise ValueError(f"{kernel}: the tensor-core form takes M and H "
                         f"that are multiples of 32, not M={m}, H={h}")


def fused_mp_edge_tile(b, e, m, h, form=FORM_BY_SHAPE):
    """(edges, outputs) of a block's tile in the forward kernel at this
    shape, from the built library (the card's machine only)."""
    te, hb = ctypes.c_int(), ctypes.c_int()
    kernels.library().dostpu_fused_mp_edge_tile(b, e, m, h, form, te, hb)
    return te.value, hb.value


def fused_mp_edge_bwd_tile(b, e, m, h, form=FORM_BY_SHAPE):
    """(edges of a tile, blocks of the cluster sharing it, g_W1 splits) of
    the backward kernel at this shape, from the built library."""
    te, cluster, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    kernels.library().dostpu_fused_mp_edge_bwd_tile(b, e, m, h, form, te,
                                                    cluster, splits)
    return te.value, cluster.value, splits.value


def _mp_operands(src_proj, dst_proj, edge_proj, senders, receivers,
                 edge_mask, ln_scale, ln_bias, alpha, w1, proj_dtype):
    b, a, m = src_proj.shape
    e = senders.shape[1]
    h = w1.shape[0]
    f32, i32 = torch.float32, torch.int32
    return {
        "src_proj": (src_proj, proj_dtype, (b, a, m)),
        "dst_proj": (dst_proj, src_proj.dtype, (b, a, m)),
        "edge_proj": (edge_proj, src_proj.dtype, (b, e, m)),
        "senders": (senders, i32, (b, e)), "receivers": (receivers, i32, (b, e)),
        "edge_mask": (edge_mask, f32, (b, e)), "ln_scale": (ln_scale, f32, (m,)),
        "ln_bias": (ln_bias, f32, (m,)), "alpha": (alpha, f32, (1,)),
        "w1": (w1, f32, (h, m))}


def _fused_mp_edge_fwd(src_proj, dst_proj, edge_proj, senders, receivers,
                       edge_mask, ln_scale, ln_bias, alpha, w1, b1,
                       form=FORM_BY_SHAPE):
    """Launch the forward kernel (CUDA tensors only): its f32 form, or its
    bf16 form for bf16 projections."""
    b, a, m = src_proj.shape
    e = senders.shape[1]
    h = w1.shape[0]
    operands = _mp_operands(src_proj, dst_proj, edge_proj, senders,
                            receivers, edge_mask, ln_scale, ln_bias, alpha, w1,
                            {torch.float32, torch.bfloat16})
    operands["b1"] = (b1, torch.float32, (h,))
    _require_all("fused_mp_edge", operands, src_proj.device)
    _check_form("fused_mp_edge", form, m, h)
    lib = kernels.library()
    _check_smem("fused_mp_edge",
                lib.dostpu_fused_mp_edge_smem_bytes(b, e, m, h, form),
                src_proj.device)
    bf16 = src_proj.dtype == torch.bfloat16
    out = dict(device=src_proj.device, dtype=src_proj.dtype)
    e_out = torch.empty((b, e, h), **out)
    agg = torch.empty((b, a, h), **out)
    # the bf16 form's unrounded e_out, which agg sums
    e32 = (torch.empty((b, e, h), device=src_proj.device,
                       dtype=torch.float32) if bf16 else None)
    kernels.launch("fused_mp_edge", "dostpu_fused_mp_edge_fwd", src_proj,
                   dst_proj, edge_proj, senders, receivers, edge_mask,
                   ln_scale, ln_bias, alpha, w1, b1, e_out, agg, e32, b, a, e,
                   m, h, form, int(bf16))
    fused_mp_edge.launches += 1
    return e_out, agg


def fused_mp_edge_bwd(src_proj, dst_proj, edge_proj, senders, receivers,
                      edge_mask, ln_scale, ln_bias, alpha, w1, g_eout, g_agg,
                      form=FORM_BY_SHAPE):
    """The backward kernel (``csrc/fused_mp_bwd.cu``); same contract as
    :func:`mp_edge_bwd_reference`. CUDA tensors only: src_proj, dst_proj,
    edge_proj, g_eout and g_agg of one dtype, float32 or bfloat16 (its bf16
    form), every other float operand float32, int32 indices, contiguous;
    anything else raises. The eight gradients are float32 in both forms.
    ``fused_mp_edge_bwd.launches`` counts kernel launches."""
    if not src_proj.is_cuda:
        raise ValueError("fused_mp_edge_bwd: the kernel takes CUDA tensors; "
                         "use mp_edge_bwd_reference on the CPU")
    b, a, m = src_proj.shape
    e = senders.shape[1]
    h = w1.shape[0]
    dev = src_proj.device
    g_eout, g_agg = g_eout.contiguous(), g_agg.contiguous()
    operands = _mp_operands(src_proj, dst_proj, edge_proj, senders,
                            receivers, edge_mask, ln_scale, ln_bias, alpha, w1,
                            {torch.float32, torch.bfloat16})
    operands["g_eout"] = (g_eout, src_proj.dtype, (b, e, h))
    operands["g_agg"] = (g_agg, src_proj.dtype, (b, a, h))
    _require_all("fused_mp_edge_bwd", operands, dev)
    _check_form("fused_mp_edge_bwd", form, m, h)
    lib = kernels.library()
    _check_smem("fused_mp_edge_bwd",
                lib.dostpu_fused_mp_edge_bwd_smem_bytes(b, e, m, h, form), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    g_src, g_dst = torch.empty((b, a, m), **f32), torch.empty((b, a, m), **f32)
    g_edge = torch.empty((b, e, m), **f32)
    g_scale, g_bias = torch.empty((m,), **f32), torch.empty((m,), **f32)
    g_alpha, g_w1 = torch.empty((1,), **f32), torch.empty((h, m), **f32)
    g_b1 = torch.empty((h,), **f32)
    scratch = torch.empty(
        (lib.dostpu_fused_mp_edge_bwd_scratch_floats(b, e, m, h, form),),
        **f32)
    kernels.launch("fused_mp_edge_bwd", "dostpu_fused_mp_edge_bwd", src_proj,
                   dst_proj, edge_proj, senders, receivers, edge_mask,
                   ln_scale, ln_bias, alpha, w1, g_eout, g_agg, g_src, g_dst,
                   g_edge, g_scale, g_bias, g_alpha, g_w1, g_b1, scratch, b,
                   a, e, m, h, form, int(src_proj.dtype == torch.bfloat16))
    fused_mp_edge_bwd.launches += 1
    return g_src, g_dst, g_edge, g_scale, g_bias, g_alpha, g_w1, g_b1


fused_mp_edge_bwd.launches = 0


@torch.library.custom_op("dostpu::fused_mp_edge_fwd", mutates_args=(),
                         device_types="cuda")
def fused_mp_edge_op(src_proj: torch.Tensor, dst_proj: torch.Tensor,
                     edge_proj: torch.Tensor, senders: torch.Tensor,
                     receivers: torch.Tensor, edge_mask: torch.Tensor,
                     ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     alpha: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one opaque op (``torch.ops.dostpu.fused_mp_edge_fwd``),
    so that ``torch.export`` and CUDA graphs see one node a launch: CUDA
    tensors launch the kernel, CPU tensors run :func:`mp_edge_reference`."""
    return _fused_mp_edge_fwd(src_proj, dst_proj, edge_proj, senders,
                              receivers, edge_mask, ln_scale, ln_bias, alpha,
                              w1, b1)


@fused_mp_edge_op.register_kernel("cpu")
def _(src_proj, dst_proj, edge_proj, senders, receivers, edge_mask, ln_scale,
      ln_bias, alpha, w1, b1):
    return mp_edge_reference(src_proj, dst_proj, edge_proj, senders,
                             receivers, edge_mask, ln_scale, ln_bias, alpha,
                             w1, b1)


@fused_mp_edge_op.register_fake
def _(src_proj, dst_proj, edge_proj, senders, receivers, edge_mask, ln_scale,
      ln_bias, alpha, w1, b1):
    b, a, _ = src_proj.shape
    e, h = senders.shape[1], w1.shape[0]
    return src_proj.new_empty((b, e, h)), src_proj.new_empty((b, a, h))


class _FusedMPEdge(torch.autograd.Function):
    """Forward through :func:`fused_mp_edge_op` (the kernel on CUDA, the
    plain version on the CPU); backward through the backward kernel (CUDA)
    or its plain version (CPU). The residuals are those the JAX VJP saves:
    the inputs minus b1; the backward recomputes the intermediates and
    returns f32 gradients (for bf16 projections the engine casts those
    three to bf16)."""

    @staticmethod
    def forward(ctx, src_proj, dst_proj, edge_proj, senders, receivers,
                edge_mask, ln_scale, ln_bias, alpha, w1, b1):
        args = (src_proj, dst_proj, edge_proj, senders, receivers, edge_mask,
                ln_scale, ln_bias, alpha, w1)
        ctx.save_for_backward(*args)
        return fused_mp_edge_op(*args, b1)

    @staticmethod
    def backward(ctx, g_eout, g_agg):
        args = ctx.saved_tensors
        if args[0].is_cuda:
            grads = fused_mp_edge_bwd(*args, g_eout, g_agg)
        else:
            grads = mp_edge_bwd_reference(*args, g_eout, g_agg)
        g_src, g_dst, g_edge, g_scale, g_bias, g_alpha, g_w1, g_b1 = grads
        return (g_src, g_dst, g_edge, None, None, None, g_scale, g_bias,
                g_alpha, g_w1, g_b1)


def fused_mp_edge(src_proj, dst_proj, edge_proj, senders, receivers,
                  edge_mask, ln_scale, ln_bias, alpha, w1, b1):
    """Fused edge pipeline; same contract as :func:`mp_edge_reference`, and
    differentiable in every float argument.

    CUDA tensors go through the kernels (float32, or their bf16 forms for
    bf16 projections; int32 indices, contiguous; anything else raises), CPU
    tensors through the plain versions.
    ``fused_mp_edge.launches`` counts forward kernel launches."""
    return _FusedMPEdge.apply(src_proj, dst_proj, edge_proj, senders,
                              receivers, edge_mask, ln_scale, ln_bias, alpha,
                              w1, b1)


fused_mp_edge.launches = 0
