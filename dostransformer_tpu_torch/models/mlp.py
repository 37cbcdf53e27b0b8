"""eDOS MLP baselines (the reference's embedder_eDOS/mlp.py): no message
passing, the node encoder and a readout only.

Counterparts of dostransformer_tpu/models/mlp.py:

  * :class:`MLPEDOS` (mlp.py:11-35): [global embedding, pooled encoded
    nodes] fused into every energy token, out_layer Linear(2h->h) ->
    LeakyReLU -> Linear(h->1) per token. Returns dos [B, bins].
  * :class:`MLP2EDOS` (mlp.py:41-56): [pooled encoded nodes, global
    embedding] -> Linear(2h->h) -> LeakyReLU -> Linear(h->bins). Returns
    dos [B, bins].

Neither launches a kernel: they have no message passing, as in the JAX
package. The edge encoder's parameters exist (the reference creates them)
but its output is read by nothing, so it is not run; its gradient is
zero in the JAX package and absent here, which AdamW treats alike.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.models.graphnetwork import (
    energy_readout,
    readout_mlp,
)
from dostransformer_tpu_torch.nn.init import materialize_
from dostransformer_tpu_torch.nn.modules import (
    GraphDecoderEDOS,
    GraphEncoderEDOS,
    masked_node_pool,
)


class _MLPBase(nn.Module):
    def __init__(self, hidden: int, node_in: int, edge_in: int,
                 glob_in: int):
        super().__init__()
        self.GN_encoder = GraphEncoderEDOS(node_in, edge_in, glob_in, hidden)

    def _encode(self, g: GraphBatch):
        """(encoded nodes, global embedding)."""
        enc = self.GN_encoder
        return enc.node_encoder(g.nodes.float()), enc.global_encoder(g.glob)


class MLPEDOS(_MLPBase):
    """Energy-token MLP baseline; returns dos [B, bins]."""

    def __init__(self, hidden: int = 256, n_bins: int = 201,
                 node_in: int = 200, edge_in: int = 41, glob_in: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(hidden, node_in, edge_in, glob_in)
            self.embeddings = nn.Embedding(n_bins, hidden)
            self.GN_decoder = GraphDecoderEDOS(hidden)
            self.out_layer = readout_mlp(2 * hidden, hidden, 1)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        x, u = self._encode(g)
        graph = self.GN_decoder(x, u, g.node_mask)
        return energy_readout(self.embeddings, graph, self.out_layer)


class MLP2EDOS(_MLPBase):
    """MLP baseline without energy tokens; returns dos [B, bins]."""

    def __init__(self, hidden: int = 256, n_bins: int = 201,
                 node_in: int = 200, edge_in: int = 41, glob_in: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(hidden, node_in, edge_in, glob_in)
            self.out_layer = readout_mlp(2 * hidden, hidden, n_bins)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        x, u = self._encode(g)
        pooled = masked_node_pool(x, g.node_mask)
        return self.out_layer(torch.cat([pooled, u], -1))
