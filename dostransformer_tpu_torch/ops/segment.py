"""Edge->node segment sums: CUDA kernel and its plain version.

Counterpart of dostransformer_tpu/ops/segment.py `batched_segment_sum` and
`batched_segment_mean` (per-graph sums over batch-leading padded arrays),
with `segment_sum_pallas`'s kernel contract: exact f32 sums, segment ids
below 0 or at or above ``num_segments`` dropped (as ``jax.ops.segment_sum``
drops them), any edge count and feature width. Callers mask pad rows
(multiply data by the mask) before aggregating.

:func:`segment_sum_reference` is the plain version. :func:`batched_segment_sum`
is the op, a ``torch.autograd.Function``: for CUDA tensors its forward is the
kernel in ``csrc/segment_sum.cu``, for CPU tensors the plain version; nothing
else chooses the path. Its backward gathers the upstream gradient at the
segment ids (the VJP of ``jax.ops.segment_sum``; no kernel, as the JAX kernel
has none). On the model's path the op counts phDOS's NodeModel edges per
receiver (the scatter-mean's denominator), at F = 1. The plain versions of
the fused message-passing kernel call :func:`segment_sum_reference`, never
the op, so that they launch no kernel on the card.
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.ops import kernels


def segment_sum_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """data [B, E, F], segment_ids [B, E] (local, in [0, num_segments))
    -> [B, num_segments, F]."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    data = torch.where(valid[..., None], data, 0)
    out = data.new_zeros((data.shape[0], num_segments) + data.shape[2:])
    index = ids.reshape(ids.shape + (1,) * (data.ndim - 2)).expand_as(data)
    return out.scatter_add_(1, index, data)


def _gather_segments(g: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """g [B, N, F] -> g[b, segment_ids[b, e]] as [B, E, F]; rows of dropped
    ids are zero."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    index = ids[..., None].expand(ids.shape + g.shape[2:])
    return torch.gather(g, 1, index) * valid[..., None].to(g.dtype)


def _segment_sum_kernel(data, segment_ids, num_segments):
    """Launch the kernel (CUDA tensors only)."""
    b, e, f = data.shape
    dev = data.device
    kernels.require("batched_segment_sum", "data", data, device=dev,
                    dtype=torch.float32, shape=(b, e, f))
    kernels.require("batched_segment_sum", "segment_ids", segment_ids,
                    device=dev, dtype=torch.int32, shape=(b, e))
    out = torch.empty((b, num_segments, f), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = kernels.library().dostpu_segment_sum(
            data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), b, e, f,
            num_segments, stream)
    kernels.check(code, "batched_segment_sum")
    batched_segment_sum.launches += 1
    return out


class _SegmentSum(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward; the backward
    gathers the upstream gradient at the ids (torch ``gather``, on either
    device)."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        if data.is_cuda:
            return _segment_sum_kernel(data, segment_ids, num_segments)
        return segment_sum_reference(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return _gather_segments(g, segment_ids, ctx.num_segments), None, None


def batched_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Same contract as :func:`segment_sum_reference`, differentiable in
    ``data``.

    CUDA tensors go through the kernel (data float32 [B, E, F], ids int32,
    both contiguous; anything else raises), CPU tensors through the plain
    version. ``batched_segment_sum.launches`` counts kernel launches."""
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
