"""Fused message-passing edge pipeline: CUDA kernel and its plain version.

Counterpart of dostransformer_tpu/ops/fused_mp.py (forward only). One GNN
processor step's edge pipeline:

    mid   = src_proj[senders] + dst_proj[receivers] + edge_proj   (gathers)
    act   = PReLU(LayerNorm(mid))
    e_out = act @ W1^T + b1                                       (edge MLP tail)
    agg   = segment_sum(e_out * edge_mask -> receivers)           (scatter)

The node-level projections (src_proj = x @ W0[:, :H]^T, ...) stay with the
caller as plain matrix products. :func:`fused_mp_edge` runs the kernel in
``csrc/fused_mp.cu`` for CUDA tensors and :func:`mp_edge_reference` for CPU
tensors; nothing else chooses the path.

Layout: batch-leading, as in the JAX package, except that ``w1`` is torch's
Linear weight ``[H, M]`` (out, in) — the JAX functions take the flax kernel
``[M, H]``. The kernel reads it as it lies, so no transpose is copied per
call.
"""

from __future__ import annotations

import torch

from dostransformer_tpu_torch.ops import kernels
from dostransformer_tpu_torch.ops.segment import batched_segment_sum

LN_EPS = 1e-5


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, F], idx [B, E] -> x[b, idx[b, e]] as [B, E, F]."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def mp_edge_reference(src_proj, dst_proj, edge_proj, senders, receivers,
                      edge_mask, ln_scale, ln_bias, alpha, w1, b1):
    """Plain PyTorch composition of the fused pipeline.

    src_proj/dst_proj [B, A, M], edge_proj [B, E, M], senders/receivers
    [B, E] int, edge_mask [B, E], ln_scale/ln_bias [M], alpha [1],
    w1 [H, M] (torch layout), b1 [H]; returns (e_out [B, E, H],
    agg [B, A, H])."""
    mid = (gather_rows(src_proj, senders) + gather_rows(dst_proj, receivers)
           + edge_proj)
    mu = mid.mean(-1, keepdim=True)
    var = ((mid - mu) ** 2).mean(-1, keepdim=True)
    norm = (mid - mu) * torch.rsqrt(var + LN_EPS) * ln_scale + ln_bias
    act = torch.clamp(norm, min=0.0) + alpha * torch.clamp(norm, max=0.0)
    e_out = torch.nn.functional.linear(act, w1, b1)
    agg = batched_segment_sum(e_out * edge_mask[..., None], receivers,
                              src_proj.shape[1])
    return e_out, agg


def fused_mp_edge(src_proj, dst_proj, edge_proj, senders, receivers,
                  edge_mask, ln_scale, ln_bias, alpha, w1, b1):
    """Fused edge pipeline; same contract as :func:`mp_edge_reference`.

    CUDA tensors go through the kernel (float32, int32 indices, contiguous;
    anything else raises), CPU tensors through :func:`mp_edge_reference`.
    ``fused_mp_edge.launches`` counts kernel launches."""
    if not src_proj.is_cuda:
        return mp_edge_reference(src_proj, dst_proj, edge_proj, senders,
                                 receivers, edge_mask, ln_scale, ln_bias,
                                 alpha, w1, b1)
    b, a, m = src_proj.shape
    e = senders.shape[1]
    h = w1.shape[0]
    f32, i32 = torch.float32, torch.int32
    operands = {
        "src_proj": (src_proj, f32, (b, a, m)),
        "dst_proj": (dst_proj, f32, (b, a, m)),
        "edge_proj": (edge_proj, f32, (b, e, m)),
        "senders": (senders, i32, (b, e)), "receivers": (receivers, i32, (b, e)),
        "edge_mask": (edge_mask, f32, (b, e)), "ln_scale": (ln_scale, f32, (m,)),
        "ln_bias": (ln_bias, f32, (m,)), "alpha": (alpha, f32, (1,)),
        "w1": (w1, f32, (h, m)), "b1": (b1, f32, (h,))}
    for arg, (t, dtype, shape) in operands.items():
        kernels.require("fused_mp_edge", arg, t, device=src_proj.device,
                        dtype=dtype, shape=shape)
    lib = kernels.library()
    smem = lib.dostpu_fused_mp_edge_smem_bytes(m)
    limit = torch.cuda.get_device_properties(
        src_proj.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"fused_mp_edge: width M={m} needs {smem} bytes of "
                         f"shared memory per block, the card allows {limit}")
    e_out = torch.empty((b, e, h), device=src_proj.device, dtype=torch.float32)
    agg = torch.empty((b, a, h), device=src_proj.device, dtype=torch.float32)
    with torch.cuda.device(src_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dostpu_fused_mp_edge_fwd(
            src_proj.data_ptr(), dst_proj.data_ptr(), edge_proj.data_ptr(),
            senders.data_ptr(), receivers.data_ptr(), edge_mask.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), alpha.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), e_out.data_ptr(), agg.data_ptr(),
            b, a, e, m, h, stream)
    kernels.check(code, "fused_mp_edge")
    fused_mp_edge.launches += 1
    return e_out, agg


fused_mp_edge.launches = 0
