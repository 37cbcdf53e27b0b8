"""Edge->node segment sums: CUDA kernel and its plain version.

Counterpart of dostransformer_tpu/ops/segment.py `batched_segment_sum` and
`batched_segment_mean` (per-graph sums over batch-leading padded arrays),
with `segment_sum_pallas`'s kernel contract: f32 sums (bf16 data is summed
in f32 and rounded once), segment ids
below 0 or at or above ``num_segments`` dropped (as ``jax.ops.segment_sum``
drops them), any edge count and feature width. Callers mask pad rows
(multiply data by the mask) before aggregating.

:func:`segment_sum_reference` is the plain version. :func:`batched_segment_sum`
is the op, a ``torch.autograd.Function``: for CUDA tensors its forward is the
kernel in ``csrc/segment_sum.cu``, for CPU tensors the plain version; nothing
else chooses the path. Its backward gathers the upstream gradient at the
segment ids (the VJP of ``jax.ops.segment_sum``; no kernel, as the JAX kernel
has none). On the model's path the op counts phDOS's NodeModel edges per
receiver (the scatter-mean's denominator), at F = 1.
:func:`segment_sum_plan` is the Python mirror of the kernel's partition
(which the card run holds equal to the library's). The plain versions of
the fused message-passing kernel call :func:`segment_sum_reference`, never
the op, so that they launch no kernel on the card.
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.ops import kernels


def segment_sum_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """data [B, E, F], segment_ids [B, E] (local, in [0, num_segments))
    -> [B, num_segments, F] in data's dtype. bf16 data is summed in f32 and
    rounded once, as the kernel's bf16 form sums it."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    wide = data.to(torch.promote_types(data.dtype, torch.float32))
    wide = torch.where(valid[..., None], wide, 0)
    out = wide.new_zeros((data.shape[0], num_segments) + data.shape[2:])
    index = ids.reshape(ids.shape + (1,) * (data.ndim - 2)).expand_as(wide)
    return out.scatter_add_(1, index, wide).to(data.dtype)


# csrc/segment_sum.cu's partition constants
_SEG_THREADS, _SEG_SMS, _SEG_BATCH, _SEG_BUDGET = 256, 132, 8, 24576


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def segment_sum_plan(b: int, e: int, f: int, n: int) -> dict:
    """The kernel's partition at this shape, the mirror of ``plan`` in
    ``csrc/segment_sum.cu`` (``dostpu_segment_sum_plan``, which the card run
    holds equal): ``vec`` floats a lane loads (4 where F % 4 == 0), ``lanes``
    feature lanes (halved until the graphs and feature slices make a block
    for each of the card's 132 SMs), ``segs`` segments a block holds and
    ``slots`` edge slots (a power of two: as many as 96 KB of private row
    blocks allow, no more than one batch of 8 edges a slot needs). At
    F = 1 the count kernel: one segment a block, 256 edge slots."""
    if f == 1:  # segment_count_kernel: a block per segment, 256 edge slots
        return dict(vec=1, lanes=1, slots=_SEG_THREADS, segs=1)
    vec = 4 if f % 4 == 0 else 1
    vecs = -(-f // vec)
    lanes = min(_pow2_ceil(vecs), 32)
    while lanes > 1 and b * -(-vecs // lanes) < _SEG_SMS:
        lanes //= 2
    tf = lanes * vec
    segs = min(n, _SEG_BUDGET // tf)
    slots = min(_SEG_THREADS // lanes, _pow2_floor(_SEG_BUDGET // (segs * tf)),
                _pow2_ceil(max(1, -(-e // _SEG_BATCH))))
    return dict(vec=vec, lanes=lanes, slots=slots, segs=segs)


def _gather_segments(g: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """g [B, N, F] -> g[b, segment_ids[b, e]] as [B, E, F]; rows of dropped
    ids are zero."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    index = ids[..., None].expand(ids.shape + g.shape[2:])
    return torch.gather(g, 1, index) * valid[..., None].to(g.dtype)


def _segment_sum_kernel(data, segment_ids, num_segments):
    """Launch the kernel (CUDA tensors only): its f32 form, or its bf16 form
    for bf16 data."""
    b, e, f = data.shape
    dev = data.device
    kernels.require("batched_segment_sum", "data", data, device=dev,
                    dtype={torch.float32, torch.bfloat16}, shape=(b, e, f))
    kernels.require("batched_segment_sum", "segment_ids", segment_ids,
                    device=dev, dtype=torch.int32, shape=(b, e))
    out = torch.empty((b, num_segments, f), device=dev, dtype=data.dtype)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    entry = (lib.dostpu_segment_sum_bf16 if data.dtype == torch.bfloat16
             else lib.dostpu_segment_sum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = entry(data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
                     b, e, f, num_segments, stream)
    kernels.check(code, "batched_segment_sum")
    batched_segment_sum.launches += 1
    return out


@torch.library.custom_op("dostpu::segment_sum", mutates_args=(),
                         device_types="cuda")
def segment_sum_op(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The forward as one opaque op (``torch.ops.dostpu.segment_sum``), so
    that ``torch.export`` and CUDA graphs see one node a launch: CUDA tensors
    launch the kernel, CPU tensors run :func:`segment_sum_reference`."""
    return _segment_sum_kernel(data, segment_ids, num_segments)


@segment_sum_op.register_kernel("cpu")
def _(data, segment_ids, num_segments):
    return segment_sum_reference(data, segment_ids, num_segments)


@segment_sum_op.register_fake
def _(data, segment_ids, num_segments):
    b, _, f = data.shape
    return data.new_empty((b, num_segments, f))


class _SegmentSum(torch.autograd.Function):
    """Forward through :func:`segment_sum_op` (the kernel on CUDA, the plain
    version on the CPU); the backward gathers the upstream gradient at the
    ids (torch ``gather``, on either device)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return segment_sum_op(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return _gather_segments(g, segment_ids, ctx.num_segments), None, None


def batched_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Same contract as :func:`segment_sum_reference`, differentiable in
    ``data``.

    CUDA tensors go through the kernel (data float32 or bfloat16
    [B, E, F], ids int32, both contiguous; anything else raises), CPU
    tensors through the plain version. ``batched_segment_sum.launches`` counts kernel launches."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


batched_segment_sum.launches = 0


def batched_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int,
                         weights: torch.Tensor) -> torch.Tensor:
    """Per-graph masked segment mean (torch_scatter scatter_mean semantics:
    empty segments give 0). ``weights`` [B, E] selects the rows that count
    toward the denominator; data rows must already be masked."""
    total = batched_segment_sum(data, segment_ids, num_segments)
    count = batched_segment_sum(weights[..., None].to(data.dtype),
                                segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0)
