"""GNN building blocks.

Counterpart of dostransformer_tpu/nn/modules.py on batch-leading fixed-shape
graph batches ([B, A, .] nodes, [B, Eg, .] edges with local indices). The
modules are named as the reference's are (Sequential indices included), so
their state_dict keys are the reference's:

  * MLP2 = Sequential(Linear, PReLU, Linear): the encoder MLPs.
  * MLPBlock = Sequential(Linear, LayerNorm, PReLU, Linear): the EdgeModel
    and NodeModel MLPs.
  * Processor = EdgeModel then NodeModel; the residuals are applied by the
    caller (:func:`run_message_passing`).

The EdgeModel runs through :func:`~dostransformer_tpu_torch.ops.fused_mp.
fused_mp_edge`: the first Linear is projected at node count (project, then
gather), and the gathers, LayerNorm, PReLU, second Linear and the masked
edge->receiver sum run in the fused kernel on the card, or in its plain
version on the CPU; its backward is the fused backward kernel on the card.
The NodeModel consumes that sum, divided for phDOS's scatter-mean by the
count of real edges per receiver (the segment-sum kernel on the card).
Every path keeps autograd: the projected weight slices, the row gathers and
the single PReLU slope (passed to the kernel as ``alpha``) all receive
gradients.

Mixed precision, as in the JAX package: parameters stay float32 and each
is cast to the operand's dtype where it is used (the Linear weights and
biases, the PReLU slope), so bf16 activations run the products in bf16;
LayerNorm statistics are f32 and its output is cast back. bf16 rounds where
the JAX package rounds (:func:`linear`, :func:`leaky_relu`). The fused edge
pipeline takes its LayerNorm parameters, slope, W1 and b1 uncast (f32), as
the TPU kernel does.

The f64 rule (ops/kernels.py ``takes_kernels``): the kernels take f32 and
bf16 and their public entries refuse f64 on the card. A float64 model is
the JAX package's f64 parity mode, which it runs with ``use_pallas=False``;
so the layers look at their operands' dtype at each call, and f64 operands
take the plain functions on every device: the unfused EdgeModel with
:func:`~dostransformer_tpu_torch.ops.segment.segment_sum_reference` in
place of the segment-sum op here, the plain attention and LayerNorm in the
transformer (nn/transformer.py). Their LayerNorm statistics are then f64
("f32 or wider").
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dostransformer_tpu_torch import tracing
from dostransformer_tpu_torch.nn.init import torch_linear_
from dostransformer_tpu_torch.nn.layernorm import LayerNorm
from dostransformer_tpu_torch.ops.fused_mp import fused_mp_edge, gather_rows
from dostransformer_tpu_torch.ops.kernels import takes_kernels
from dostransformer_tpu_torch.ops.linear import linear_op, linear_plan
from dostransformer_tpu_torch.ops.segment import (
    batched_segment_sum,
    segment_sum_reference,
)

Parts = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ weight^T + bias with the parameters cast to x's dtype: the
    product of every linear of the model but the transformer's FFN on #8.
    In bf16 the product is rounded before the bias is added, as the JAX
    package rounds it (``y = x @ k; y + b``); a fused call would round
    once. f32 keeps the one fused call (the two differ by an f32 rounding):
    kernel #9 where :func:`~dostransformer_tpu_torch.ops.linear.linear_plan`
    says so (``linear_op``: ``F.linear`` itself on the CPU), else
    ``F.linear``; f64 takes ``F.linear``. ``weight`` may be a column slice
    of a parameter. ``tracing`` counts every call's rows
    (``linear.rows``) and the rows that took #9 (``linear.kernel_rows``)."""
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


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU, slope 0.01 as the operand's dtype holds it: JAX casts the
    Python scalar to bf16 before it multiplies, so in bf16 the slope is
    bf16(0.01) = 0.010009765625 (in f32 it is f32(0.01), F.leaky_relu's
    own)."""
    return F.leaky_relu(
        x, 0.010009765625 if x.dtype == torch.bfloat16 else 0.01)


class TorchLinear(nn.Linear):
    """nn.Linear with torch's default initialisation drawn from a passed
    generator.

    Split/gather form: ``x`` may be a sequence of ``(tensor, gather_idx)``
    pairs whose (gathered) concatenation along the last axis is the logical
    input. Each part is projected through its slice of the weight FIRST and
    gathered along axis 1 AFTER: the same product as concatenate-then-matmul,
    with node-level parts projected at node count instead of edge count."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if not self.weight.is_meta:
            torch_linear_(self.weight, self.bias, generator)

    def forward(self, x: Union[torch.Tensor, Parts]) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return linear(x, self.weight, self.bias)
        dtype = x[0][0].dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        weight = self.weight.to(dtype)
        off, y = 0, None
        for t, idx in x:
            part = linear(t, weight[:, off:off + t.shape[-1]], None)
            if idx is not None:
                part = gather_rows(part, idx)
            y = part if y is None else y + part
            off += t.shape[-1]
        return y if bias is None else y + bias


class PReLU(nn.PReLU):
    """nn.PReLU (one shared slope, init 0.25) with the slope cast to the
    operand's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class MLP2(nn.Sequential):
    """Linear(in->h) -> PReLU -> Linear(h->h): the encoder MLP."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__(TorchLinear(in_features, hidden), PReLU(),
                         TorchLinear(hidden, hidden))


class MLPBlock(nn.Sequential):
    """Linear(in->mid) -> LayerNorm -> PReLU -> Linear(mid->out); the
    LayerNorm takes f32 statistics and casts back."""

    def __init__(self, in_features: int, mid: int, out: int):
        super().__init__(TorchLinear(in_features, mid), LayerNorm(mid),
                         PReLU(), TorchLinear(mid, out))

    def forward(self, x: Union[torch.Tensor, Parts]) -> torch.Tensor:
        lin0, ln, prelu, lin1 = self
        return lin1(prelu(ln(lin0(x))))

    def fused_edge(self, x, senders, receivers, edge_attr, edge_mask):
        """The block on the edge input [x[senders], x[receivers], edge_attr]
        through the fused kernel; returns (e_out [B, E, out], the masked sum
        of e_out onto receivers [B, A, out]), both in x's dtype."""
        lin0, ln, prelu, lin1 = self
        h = x.shape[-1]
        w0 = lin0.weight.to(x.dtype)
        src_proj = linear(x, w0[:, :h], None)
        dst_proj = linear(x, w0[:, h:2 * h], None)
        edge_proj = linear(edge_attr, w0[:, 2 * h:], lin0.bias)
        return fused_mp_edge(src_proj, dst_proj, edge_proj, senders,
                             receivers, edge_mask, ln.weight, ln.bias,
                             prelu.weight, lin1.weight, lin1.bias)


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The segment-sum op, or its plain version for f64 ``data`` (the f64
    rule)."""
    op = (batched_segment_sum if takes_kernels(data.dtype)
          else segment_sum_reference)
    return op(data, segment_ids, num_segments)


class EdgeModel(nn.Module):
    """e' = MLP([x_src, x_dst, e]); also returns the masked sum of e' onto
    the receivers, which the NodeModel aggregates: through the fused op
    (``fused``, the default), or as the plain composition (project, gather,
    the MLP, then the masked segment sum; the JAX package's
    ``use_fused_mp=False``). f64 operands take the plain composition with
    the plain segment sum (the f64 rule)."""

    def __init__(self, hidden: int, fused: bool = True):
        super().__init__()
        self.fused = fused
        self.edge_mlp = MLPBlock(3 * hidden, 2 * hidden, hidden)

    def forward(self, x, senders, receivers, edge_attr, edge_mask):
        if self.fused and takes_kernels(x.dtype):
            return self.edge_mlp.fused_edge(x, senders, receivers, edge_attr,
                                            edge_mask)
        e_out = self.edge_mlp(((x, senders), (x, receivers),
                               (edge_attr, None)))
        masked = e_out * edge_mask[..., None].to(e_out.dtype)
        return e_out, _segment_sum(masked, receivers, x.shape[1])


class NodeModel(nn.Module):
    """x' = MLP([x, agg]) with agg the edge features aggregated onto their
    receivers: their masked sum as the EdgeModel returns it ("sum", eDOS's
    scatter_sum), or that sum over the count of real edges per receiver
    ("mean", phDOS's scatter_mean; a node with no edge gets 0). The count is
    the segment-sum op on the edge mask: the kernel on the card (its plain
    version for f64 operands)."""

    def __init__(self, hidden: int, aggregation: str = "sum"):
        super().__init__()
        if aggregation not in ("sum", "mean"):
            raise ValueError(f"unknown aggregation {aggregation!r}; expected "
                             f"'sum' or 'mean'")
        self.aggregation = aggregation
        self.node_mlp_2 = MLPBlock(2 * hidden, 2 * hidden, hidden)

    def forward(self, x, agg, receivers, edge_mask):
        if self.aggregation == "mean":
            count = _segment_sum(edge_mask[..., None].to(agg.dtype),
                                 receivers, x.shape[1])
            agg = agg / torch.clamp(count, min=1.0)
        return self.node_mlp_2(((x, None), (agg, None)))


class Processor(nn.Module):
    """One message-passing step; the residual is applied by the caller."""

    def __init__(self, hidden: int, aggregation: str = "sum",
                 fused: bool = True):
        super().__init__()
        self.edge_model = EdgeModel(hidden, fused)
        self.node_model = NodeModel(hidden, aggregation)

    def forward(self, x, senders, receivers, edge_attr, edge_mask):
        edge_attr, agg = self.edge_model(x, senders, receivers, edge_attr,
                                         edge_mask)
        return self.node_model(x, agg, receivers, edge_mask), edge_attr


def run_message_passing(processors: Sequence[Processor], g, x, edge_attr,
                        remat: bool = False):
    """The reference's processor loop with CALLER-side residuals. With
    ``remat``, while gradients are recorded each processor keeps only its
    inputs and is run again in the backward (``torch.utils.checkpoint``, as
    the JAX package wraps its Processor in ``flax.linen.remat``). The
    processors run the kernel ops on f32 and bf16 operands and the plain
    functions on f64 ones (the f64 rule, see the module docstring)."""
    for proc in processors:
        args = (x, g.senders, g.receivers, edge_attr, g.edge_mask)
        if remat and torch.is_grad_enabled():
            out_x, out_e = checkpoint(proc, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            out_x, out_e = proc(*args)
        x = x + out_x
        edge_attr = edge_attr + out_e
    return x, edge_attr


class GraphEncoderEDOS(nn.Module):
    """eDOS Encoder: node, edge and global MLPs."""

    def __init__(self, node_in: int, edge_in: int, glob_in: int,
                 hidden: int):
        super().__init__()
        self.node_encoder = MLP2(node_in, hidden)
        self.edge_encoder = MLP2(edge_in, hidden)
        self.global_encoder = MLP2(glob_in, hidden)

    def forward(self, x, edge_attr, glob):
        return (self.node_encoder(x), self.edge_encoder(edge_attr),
                self.global_encoder(glob))


class GraphEncoderPhDOS(nn.Module):
    """phDOS Encoder: node and edge MLPs, no global features."""

    def __init__(self, node_in: int, edge_in: int, hidden: int):
        super().__init__()
        self.node_encoder = MLP2(node_in, hidden)
        self.edge_encoder = MLP2(edge_in, hidden)

    def forward(self, x, edge_attr):
        return self.node_encoder(x), self.edge_encoder(edge_attr)


def masked_node_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """scatter_sum(x, batch) in batch-leading layout: masked sum over the
    node axis. x [B, A, h] -> [B, h]."""
    return (x * node_mask[..., None].to(x.dtype)).sum(dim=1)


class GraphDecoderEDOS(nn.Module):
    """Linear(2h->h)([glob_emb, pooled nodes])."""

    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(TorchLinear(2 * hidden, hidden))

    def forward(self, x, u, node_mask):
        return self.mlp(torch.cat([u, masked_node_pool(x, node_mask)], dim=-1))


class GraphDecoderPhDOS(nn.Module):
    """Linear(h->h)(pooled nodes)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(TorchLinear(hidden, hidden))

    def forward(self, x, node_mask):
        return self.mlp(masked_node_pool(x, node_mask))
