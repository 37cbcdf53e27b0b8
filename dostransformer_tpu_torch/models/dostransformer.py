"""DOSTransformer, eDOS flagship: prompt-guided multimodal transformer.

Counterpart of dostransformer_tpu/models/dostransformer.py
`DOSTransformerEDOS` (and the parts of `_DOSTransformerBase` it uses):

  * a learned per-energy-bin embedding table provides "energy tokens";
  * a crystal-graph message-passing GNN encodes atoms over fixed-shape
    padded batches;
  * energy tokens cross-attend against the atoms (projection-free
    attention);
  * a graph readout is fused into every energy token; a global head and a
    crystal-system "prompt token" head emit one DOS value per bin. The
    self/source transformer stacks and the output linear are shared by the
    two heads, which run as ONE 2B-batch pass.

Returns (dos_global [B, bins], node_embeddings [B, A, h], dos_system
[B, bins]). Submodules are named as the reference's state_dict names them
(``GN_encoder.node_encoder.0``, ``stacked_processor.{i}``,
``transformer.layers.{i}.layer_norms.{0,1}``, ``promt_token`` — the eDOS
spelling — ``fc``, ``fc_prompt``, ``out_layer``), so a reference-trained
state_dict loads directly (see models/import_torch.py).

The forward serves (under ``torch.inference_mode``) and trains: every path
keeps autograd, and on the card the fused message-passing and attention
kernels run forward and backward (``torch.autograd.Function``s in ``ops/``).

Parameters are created on the meta device and then materialised on
``device`` and drawn from ``generator`` (on the CPU, so a seed gives the same
weights on every device).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.nn.init import embedding_
from dostransformer_tpu_torch.nn.modules import (
    GraphDecoderEDOS,
    GraphEncoderEDOS,
    Processor,
    TorchLinear,
    run_message_passing,
)
from dostransformer_tpu_torch.nn.transformer import (
    TransformerEncoder,
    XavierLinear,
)

_LATER = "ROADMAP.md queue 1"


class DOSTransformerEDOS(nn.Module):
    """eDOS flagship (201 bins), float32, serving and training."""

    def __init__(
        self,
        layers: int = 3,
        t_layers: int = 2,
        hidden: int = 256,
        n_bins: int = 201,
        padding: str = "mask",
        node_in: int = 200,
        edge_in: int = 41,
        glob_in: int = 2,
        *,
        attn_drop: float = 0.0,
        dtype: str = "float32",
        bins_pad: Optional[int] = None,
        tp_axis: Optional[str] = None,
        remat: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if padding not in ("mask", "ref"):
            raise ValueError(f"unknown padding {padding!r}; expected 'mask' "
                             f"or 'ref'")
        unported = {"attn_drop > 0 (item 2, attention dropout)":
                        attn_drop > 0.0,
                    "dtype other than float32 (bf16 slice)":
                        dtype != "float32",
                    "bins_pad (TPU lane alignment; not ported)":
                        bins_pad is not None,
                    "tp_axis (item 9, parallelism)": tp_axis is not None,
                    "remat (item 6, training runtime)": remat}
        for what, given in unported.items():
            if given:
                raise NotImplementedError(
                    f"DOSTransformerEDOS: {what} is not in the port yet; see "
                    f"{_LATER}")
        self.n_bins = n_bins
        self.hidden = hidden
        self.padding = padding
        with torch.device("meta"):
            self.embeddings = nn.Embedding(n_bins, hidden)
            self.promt_token = nn.Embedding(7, hidden // 2)
            self.GN_encoder = GraphEncoderEDOS(node_in, edge_in, glob_in,
                                               hidden)
            self.stacked_processor = nn.ModuleList(
                Processor(hidden) for _ in range(layers))
            self.GN_decoder = GraphDecoderEDOS(hidden)
            self.transformer = TransformerEncoder(hidden, t_layers)
            self.transformer_self = TransformerEncoder(hidden, t_layers)
            self.transformer_source = TransformerEncoder(hidden, t_layers)
            self.fc = TorchLinear(2 * hidden, hidden)
            self.fc_prompt = TorchLinear(2 * hidden + hidden // 2, hidden)
            self.out_layer = TorchLinear(hidden, 1)
        self.to_empty(device=device if device is not None else "cpu")
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter from ``generator`` in module order."""
        for m in self.modules():
            if isinstance(m, (TorchLinear, XavierLinear)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Embedding):
                embedding_(m.weight, generator)
            elif isinstance(m, (nn.LayerNorm, nn.PReLU)):
                m.reset_parameters()

    def forward(self, g: GraphBatch):
        b = g.num_graphs
        energies = self.embeddings.weight.expand(b, -1, -1)
        x, edge_attr, u = self.GN_encoder(g.nodes, g.edges, g.glob)
        x, edge_attr = run_message_passing(self.stacked_processor, g, x,
                                           edge_attr)

        # to_dense_batch is the identity in batch-leading layout; zero the
        # pad rows as torch to_dense_batch does
        x_dense = x * g.node_mask[..., None].to(x.dtype)
        # "mask": pad atoms are masked out of the keys; "ref": zero pad rows
        # act as keys, as in the reference (which builds no key mask)
        key_mask = g.node_mask > 0.5 if self.padding == "mask" else None
        energies = self.transformer(energies, x_dense, x_dense, key_mask)

        graph = self.GN_decoder(x, u, g.node_mask)
        graph = graph[:, None, :].expand(b, self.n_bins, self.hidden)
        dos_global, dos_system = self._heads(g, energies, graph, x_dense,
                                             key_mask)
        return dos_global, x, dos_system

    def _heads(self, g: GraphBatch, energies, graph, x_dense, key_mask):
        """The global and system heads share transformer_self,
        transformer_source and out_layer; attention, LN and FFN act per
        batch element, so both heads run as ONE 2B-batch pass."""
        b = energies.shape[0]
        dos_in_g = F.leaky_relu(self.fc(torch.cat([energies, graph], -1)))
        prompt = self.promt_token(g.system.long())
        prompt = prompt[:, None, :].expand(b, self.n_bins, prompt.shape[-1])
        dos_in_s = F.leaky_relu(
            self.fc_prompt(torch.cat([energies, graph, prompt], -1)))

        both = torch.cat([dos_in_g, dos_in_s], 0)            # [2B, bins, h]
        kv = torch.cat([x_dense, x_dense], 0)
        km = torch.cat([key_mask, key_mask], 0) if key_mask is not None else None
        both = self.transformer_self(both)
        both = self.transformer_source(both, kv, kv, km)
        both = self.out_layer(both)[..., 0]                  # [2B, bins]
        return both[:b], both[b:]
