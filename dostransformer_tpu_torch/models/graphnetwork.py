"""eDOS GNN baselines (the reference's embedder_eDOS/graphnetwork.py).

Counterparts of dostransformer_tpu/models/graphnetwork.py:

  * :class:`GraphnetworkEDOS` (graphnetwork.py:10-43): the encoders, the
    processors, the readout [global embedding, pooled nodes] fused into
    every energy token, and out_layer Linear(2h->h) -> LeakyReLU ->
    Linear(h->1) per token. Returns (dos [B, bins], node embeddings
    [B, A, h]).
  * :class:`Graphnetwork2EDOS` (graphnetwork.py:48-74): no energy tokens;
    [pooled nodes, global embedding] -> Linear(2h->h) -> LeakyReLU ->
    Linear(h->bins). Returns (dos, node embeddings). The reference's forward
    calls its Encoder with the wrong arity (graphnetwork.py:64 vs :94); this
    is the intent, as in the JAX package. Its Decoder, never called, is not
    built (models/import_torch.py drops it from a reference state_dict).

The processors are the flagships' (nn/modules.py): on the card each runs the
fused message-passing kernel forward and backward. Submodules carry the
reference's names (``GN_encoder``, ``stacked_processor.{i}``,
``GN_decoder.mlp.0``, ``out_layer.{0,2}``), so a reference state_dict loads.
Parameters are created on the meta device, then placed on ``device`` and
drawn from ``generator`` (nn/init.py).

Each forward takes the Trainer's dropout ``generator`` and ignores it:
these models have no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.nn.init import materialize_
from dostransformer_tpu_torch.nn.modules import (
    GraphDecoderEDOS,
    GraphEncoderEDOS,
    Processor,
    TorchLinear,
    masked_node_pool,
    run_message_passing,
)


def readout_mlp(in_features: int, hidden: int, out: int) -> nn.Sequential:
    """The baselines' out_layer: Linear -> LeakyReLU -> Linear (index 1 has
    no parameters, so the reference's keys are out_layer.0 and .2)."""
    return nn.Sequential(TorchLinear(in_features, hidden), nn.LeakyReLU(),
                         TorchLinear(hidden, out))


def energy_readout(embeddings: nn.Embedding, graph: torch.Tensor,
                   out_layer: nn.Module) -> torch.Tensor:
    """One DOS value per energy token: out_layer([token, graph readout])
    for each of the bins. graph [B, h] -> [B, bins]."""
    b, (bins, h) = graph.shape[0], embeddings.weight.shape
    tokens = embeddings.weight.expand(b, bins, h)
    graph = graph[:, None, :].expand(b, bins, graph.shape[-1])
    return out_layer(torch.cat([tokens, graph], -1))[..., 0]


class _GraphnetworkBase(nn.Module):
    def __init__(self, layers: int, hidden: int, node_in: int, edge_in: int,
                 glob_in: int):
        super().__init__()
        self.GN_encoder = GraphEncoderEDOS(node_in, edge_in, glob_in, hidden)
        self.stacked_processor = nn.ModuleList(
            Processor(hidden, "sum") for _ in range(layers))

    def _encode(self, g: GraphBatch):
        """The encoders and the processors: (node embeddings, global
        embedding)."""
        x, edge_attr, u = self.GN_encoder(g.nodes.float(), g.edges.float(),
                                          g.glob)
        x, _ = run_message_passing(self.stacked_processor, g, x, edge_attr)
        return x, u


class GraphnetworkEDOS(_GraphnetworkBase):
    """Energy-token GNN baseline; returns (dos, node embeddings)."""

    def __init__(self, layers: int = 3, hidden: int = 256, n_bins: int = 201,
                 node_in: int = 200, edge_in: int = 41, glob_in: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(layers, hidden, node_in, edge_in, glob_in)
            self.embeddings = nn.Embedding(n_bins, hidden)
            self.GN_decoder = GraphDecoderEDOS(hidden)
            self.out_layer = readout_mlp(2 * hidden, hidden, 1)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch,
                generator: Optional[torch.Generator] = None):
        x, u = self._encode(g)
        graph = self.GN_decoder(x, u, g.node_mask)
        return energy_readout(self.embeddings, graph, self.out_layer), x


class Graphnetwork2EDOS(_GraphnetworkBase):
    """GNN baseline without energy tokens; returns (dos, node
    embeddings)."""

    def __init__(self, layers: int = 3, hidden: int = 256, n_bins: int = 201,
                 node_in: int = 200, edge_in: int = 41, glob_in: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(layers, hidden, node_in, edge_in, glob_in)
            self.out_layer = readout_mlp(2 * hidden, hidden, n_bins)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch,
                generator: Optional[torch.Generator] = None):
        x, u = self._encode(g)
        pooled = masked_node_pool(x, g.node_mask)
        return self.out_layer(torch.cat([pooled, u], -1)), x
