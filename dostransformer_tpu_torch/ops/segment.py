"""Edge->node segment aggregation (plain PyTorch).

Counterpart of dostransformer_tpu/ops/segment.py `batched_segment_sum` and
`batched_segment_mean`: per-graph sums over batch-leading padded arrays.
Out-of-range segment ids are dropped, as ``jax.ops.segment_sum`` drops them;
callers mask pad rows (multiply data by the mask) before aggregating. The
sum is the NodeModel aggregation inside `mp_edge_reference`, the plain
version of the fused message-passing kernel (which sums on the card); the
mean is phDOS's NodeModel aggregation.
"""

from __future__ import annotations

import torch


def batched_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """data [B, E, F], segment_ids [B, E] (local, in [0, num_segments))
    -> [B, num_segments, F]."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    data = torch.where(valid[..., None], data, 0)
    out = data.new_zeros((data.shape[0], num_segments) + data.shape[2:])
    index = ids.reshape(ids.shape + (1,) * (data.ndim - 2)).expand_as(data)
    return out.scatter_add_(1, index, data)


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
