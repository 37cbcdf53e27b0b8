"""DOSTransformer flagships, eDOS and phDOS: prompt-guided multimodal
transformer.

Counterpart of dostransformer_tpu/models/dostransformer.py
`DOSTransformerEDOS`, `DOSTransformerPhDOS` and the parts of
`_DOSTransformerBase` they use:

  * a learned per-energy-bin embedding table provides "energy tokens";
  * a crystal-graph message-passing GNN encodes atoms over fixed-shape
    padded batches;
  * energy tokens cross-attend against the atoms (projection-free
    attention);
  * a graph readout is fused into every energy token; a global head and a
    crystal-system "prompt token" head emit one DOS value per bin. The
    self/source transformer stacks and the output linear are shared by the
    two heads, which run as ONE 2B-batch pass.

The two flagships differ in their encoders, aggregation and readout: eDOS
(201 bins) encodes node, edge and global features, sums messages and reads
out [global embedding, pooled nodes]; phDOS (51 bins) computes its edge
features in the model from the edge vectors (SH l<=1 x smooth cutoff, f32),
has no global features, averages messages (scatter-mean) and reads out the
pooled nodes.

Returns (dos_global [B, bins], node_embeddings [B, A, h], dos_system
[B, bins]). Submodules are named as the reference's state_dict names them
(``GN_encoder.node_encoder.0``, ``stacked_processor.{i}``,
``transformer.layers.{i}.layer_norms.{0,1}``, ``fc``, ``fc_prompt``,
``out_layer``, and the prompt table ``promt_token`` in eDOS's spelling,
``prompt_token`` in phDOS's), so a reference-trained state_dict loads
directly (see models/import_torch.py).

The forward serves (under ``torch.inference_mode``) and trains: every path
keeps autograd, and on the card the fused message-passing and attention
kernels run forward and backward, and phDOS's edge count runs through the
segment-sum kernel (``torch.autograd.Function``s in ``ops/``). The options
``fuse_ln_attn`` and ``ln_lp`` (both off by default) switch the three
transformer stacks to the LN-fused attention forward and to the
single-pass LayerNorm backward (see nn/transformer.py); the state_dict is
the same either way. ``remat`` recomputes each processor and each
transformer layer in the backward instead of keeping their activations
(``torch.utils.checkpoint``, where the JAX package puts ``flax.linen.remat``):
the same gradients for one more forward of each.

``dtype`` is the compute dtype, as in the JAX package: "float32" (the
default) or "bfloat16". Parameters stay float32 either way (the same
state_dict, loaded the same way); a bf16 model casts its inputs, energy
tokens and prompt tokens to bf16, every layer casts its parameters to the
operand's dtype at use, LayerNorm statistics and the softmax run in f32,
and the three outputs come back as float32. On the card the bf16 forward
runs the bf16 forms of the fused message-passing, attention (and, with
``fuse_ln_attn``, LN-fused attention) and segment-sum kernels, and its
backward the bf16 forms of the message-passing and attention backward
kernels (with ``remat`` the recomputed forward runs the bf16 forward
kernels again).

Parameters are created on the meta device and then materialised on
``device`` and drawn from ``generator`` (on the CPU, so a seed gives the same
weights on every device).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.nn.init import init_parameters_, materialize_
from dostransformer_tpu_torch.nn.modules import (
    GraphDecoderEDOS,
    GraphDecoderPhDOS,
    GraphEncoderEDOS,
    GraphEncoderPhDOS,
    Processor,
    TorchLinear,
    leaky_relu,
    run_message_passing,
)
from dostransformer_tpu_torch.nn.transformer import TransformerEncoder
from dostransformer_tpu_torch.ops.geometry import edge_geometry_phdos

_LATER = "ROADMAP.md queue 1"
# compute dtypes by name: those the port runs, and those it does not yet
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_UNPORTED_DTYPES = {"float64": "item 5, f64 phDOS"}


class _DOSTransformerBase(nn.Module):
    """What both flagships share: the energy tokens, the processors, the
    three transformer stacks, the padding modes and the 2B-batch heads."""

    _PROMPT = "promt_token"  # the prompt table's name in the reference

    def __init__(self, layers: int, t_layers: int, hidden: int, n_bins: int,
                 padding: str, aggregation: str,
                 encoder: Callable[[], nn.Module],
                 decoder: Callable[[], nn.Module], *,
                 attn_drop: float = 0.0, dtype: str = "float32",
                 bins_pad: Optional[int] = None,
                 tp_axis: Optional[str] = None, remat: bool = False,
                 fuse_ln_attn: bool = False, ln_lp: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("mask", "ref"):
            raise ValueError(f"unknown padding {padding!r}; expected 'mask' "
                             f"or 'ref'")
        if dtype not in DTYPES and dtype not in _UNPORTED_DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                             f"{sorted([*DTYPES, *_UNPORTED_DTYPES])}")
        unported = {f"dtype {dtype} ({_UNPORTED_DTYPES.get(dtype)})":
                        dtype in _UNPORTED_DTYPES,
                    "attn_drop > 0 (item 2, attention dropout)":
                        attn_drop > 0.0,
                    "bins_pad (TPU lane alignment; not ported)":
                        bins_pad is not None,
                    "tp_axis (item 9, parallelism)": tp_axis is not None}
        for what, given in unported.items():
            if given:
                raise NotImplementedError(
                    f"{type(self).__name__}: {what} is not in the port yet; "
                    f"see {_LATER}")
        self.n_bins = n_bins
        self.hidden = hidden
        self.padding = padding
        self.remat = remat
        self.cdtype = DTYPES[dtype]
        with torch.device("meta"):
            self.embeddings = nn.Embedding(n_bins, hidden)
            setattr(self, self._PROMPT, nn.Embedding(7, hidden // 2))
            self.GN_encoder = encoder()
            self.stacked_processor = nn.ModuleList(
                Processor(hidden, aggregation) for _ in range(layers))
            self.GN_decoder = decoder()
            # the LayerNorm levers of nn/transformer.py, for all three stacks
            self.transformer, self.transformer_self, self.transformer_source = (
                TransformerEncoder(hidden, t_layers, fuse_ln_attn, ln_lp,
                                   remat=remat)
                for _ in range(3))
            self.fc = TorchLinear(2 * hidden, hidden)
            self.fc_prompt = TorchLinear(2 * hidden + hidden // 2, hidden)
            self.out_layer = TorchLinear(hidden, 1)
        materialize_(self, device, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter from ``generator`` in module order."""
        init_parameters_(self, generator)

    def _run(self, g: GraphBatch, x, edge_attr, readout):
        """Everything after the encoders: message passing, the
        cross-attention stack, the readout ``readout(x) -> [B, h]`` and the
        heads."""
        b = g.num_graphs
        x, _ = run_message_passing(self.stacked_processor, g, x, edge_attr,
                                   remat=self.remat)

        # to_dense_batch is the identity in batch-leading layout; zero the
        # pad rows as torch to_dense_batch does
        x_dense = x * g.node_mask[..., None].to(x.dtype)
        # "mask": pad atoms are masked out of the keys; "ref": zero pad rows
        # act as keys, as in the reference (which builds no key mask)
        key_mask = g.node_mask > 0.5 if self.padding == "mask" else None
        energies = self.embeddings.weight.to(self.cdtype).expand(b, -1, -1)
        energies = self.transformer(energies, x_dense, x_dense, key_mask)

        graph = readout(x)[:, None, :].expand(b, self.n_bins, self.hidden)
        dos_global, dos_system = self._heads(g, energies, graph, x_dense,
                                             key_mask)
        # the node embeddings widen bf16 back to f32, as the outputs do
        return dos_global, x.float(), dos_system

    def _heads(self, g: GraphBatch, energies, graph, x_dense, key_mask):
        """The global and system heads share transformer_self,
        transformer_source and out_layer; attention, LN and FFN act per
        batch element, so both heads run as ONE 2B-batch pass."""
        b = energies.shape[0]
        dos_in_g = leaky_relu(self.fc(torch.cat([energies, graph], -1)))
        prompt = F.embedding(g.system.long(),
                             getattr(self, self._PROMPT).weight.to(
                                 self.cdtype))
        prompt = prompt[:, None, :].expand(b, self.n_bins, prompt.shape[-1])
        dos_in_s = leaky_relu(
            self.fc_prompt(torch.cat([energies, graph, prompt], -1)))

        both = torch.cat([dos_in_g, dos_in_s], 0)            # [2B, bins, h]
        kv = torch.cat([x_dense, x_dense], 0)
        km = torch.cat([key_mask, key_mask], 0) if key_mask is not None else None
        both = self.transformer_self(both)
        both = self.transformer_source(both, kv, kv, km)
        # the outputs widen bf16 back to f32
        both = self.out_layer(both)[..., 0].float()          # [2B, bins]
        return both[:b], both[b:]


class DOSTransformerEDOS(_DOSTransformerBase):
    """eDOS flagship (201 bins, scatter-sum), serving and training."""

    def __init__(self, layers: int = 3, t_layers: int = 2, hidden: int = 256,
                 n_bins: int = 201, padding: str = "mask", node_in: int = 200,
                 edge_in: int = 41, glob_in: int = 2, **options):
        super().__init__(
            layers, t_layers, hidden, n_bins, padding, "sum",
            lambda: GraphEncoderEDOS(node_in, edge_in, glob_in, hidden),
            lambda: GraphDecoderEDOS(hidden), **options)

    def forward(self, g: GraphBatch):
        # the inputs in the compute dtype, as the JAX model casts them (also
        # features stored in bf16, a device dataset's bf16 storage)
        x, edge_attr, u = self.GN_encoder(
            *(t.to(self.cdtype) for t in (g.nodes, g.edges, g.glob)))
        return self._run(g, x, edge_attr,
                         lambda x: self.GN_decoder(x, u, g.node_mask))


class DOSTransformerPhDOS(_DOSTransformerBase):
    """phDOS flagship (51 bins, scatter-mean), serving and training. Node
    features are 118 atomic-mass rows; the 4 edge features are computed in
    f32 from ``g.edge_vec`` with cutoff radius ``r_max``, then cast to the
    compute dtype."""

    _PROMPT = "prompt_token"
    EDGE_FEATURES = 4  # SH l<=1: 1x0e + 1x1o

    def __init__(self, layers: int = 3, t_layers: int = 2, hidden: int = 256,
                 n_bins: int = 51, padding: str = "mask", node_in: int = 118,
                 r_max: float = 4.0, **options):
        super().__init__(
            layers, t_layers, hidden, n_bins, padding, "mean",
            lambda: GraphEncoderPhDOS(node_in, self.EDGE_FEATURES, hidden),
            lambda: GraphDecoderPhDOS(hidden), **options)
        self.r_max = r_max

    def forward(self, g: GraphBatch):
        edge_attr = edge_geometry_phdos(g.edge_vec.float(), self.r_max)
        x, edge_attr = self.GN_encoder(g.nodes.to(self.cdtype),
                                       edge_attr.to(self.cdtype))
        return self._run(g, x, edge_attr,
                         lambda x: self.GN_decoder(x, g.node_mask))
