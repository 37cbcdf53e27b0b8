"""phDOS baselines (the reference's embedder_phDOS/graphnetwork_phonon.py
and embedder_phDOS/mlp_phonon.py).

Counterparts of dostransformer_tpu/models/phonon_baselines.py. Three of the
four reference forwards call a module with the wrong arity and crash
(graphnetwork_phonon.py:114 vs :148; mlp_phonon.py:29, 31 vs :96, 136;
mlp_phonon.py:72 vs :96); each class here is the intent the JAX package
implements, noted in its docstring. Each returns dos [B, 51].

  * :class:`GraphnetworkPhDOS` and :class:`Graphnetwork2PhDOS` run the
    flagship's processors with scatter-mean (graphnetwork_phonon.py:234): on
    the card the fused message-passing kernel forward and backward and the
    segment-sum kernel for the edge count.
  * :class:`MLPPhDOS` and :class:`MLP2PhDOS` launch no kernel.

Edge features from the edge vectors (SH l<=1 x smooth cutoff) are computed in
f32 as the flagship computes them (ops/geometry.py).
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
    MLP2,
    GraphDecoderEDOS,
    GraphDecoderPhDOS,
    GraphEncoderPhDOS,
    MLPBlock,
    Processor,
    masked_node_pool,
    run_message_passing,
)
from dostransformer_tpu_torch.ops.geometry import edge_geometry_phdos

EDGE_FEATURES = 4  # SH l<=1: 1x0e + 1x1o


class _GraphnetworkPhBase(nn.Module):
    def __init__(self, layers: int, hidden: int, node_in: int, r_max: float):
        super().__init__()
        self.r_max = r_max
        self.GN_encoder = GraphEncoderPhDOS(node_in, EDGE_FEATURES, hidden)
        self.stacked_processor = nn.ModuleList(
            Processor(hidden, "mean") for _ in range(layers))

    def _encode(self, g: GraphBatch):
        edge_attr = edge_geometry_phdos(g.edge_vec, self.r_max)
        x, edge_attr = self.GN_encoder(g.nodes.float(), edge_attr)
        return run_message_passing(self.stacked_processor, g, x, edge_attr)[0]


class GraphnetworkPhDOS(_GraphnetworkPhBase):
    """Energy-token phonon GNN (graphnetwork_phonon.py:14-72): the pooled
    node readout fused into every energy token, out_layer Linear(2h->h) ->
    LeakyReLU -> Linear(h->1) per token."""

    def __init__(self, layers: int = 3, hidden: int = 256, n_bins: int = 51,
                 node_in: int = 118, r_max: float = 4.0, device=None,
                 generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(layers, hidden, node_in, r_max)
            self.embeddings = nn.Embedding(n_bins, hidden)
            self.GN_decoder = GraphDecoderPhDOS(hidden)
            self.out_layer = readout_mlp(2 * hidden, hidden, 1)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        graph = self.GN_decoder(self._encode(g), g.node_mask)
        return energy_readout(self.embeddings, graph, self.out_layer)


class Graphnetwork2PhDOS(_GraphnetworkPhBase):
    """Phonon GNN without energy tokens (graphnetwork_phonon.py:78-124;
    intent: the encoder is called without energies): sum-pooled nodes ->
    Linear(h->h/2) -> LeakyReLU -> Linear(h/2->bins) (:85, :121-122)."""

    def __init__(self, layers: int = 3, hidden: int = 256, n_bins: int = 51,
                 node_in: int = 118, r_max: float = 4.0, device=None,
                 generator: Optional[torch.Generator] = None):
        with torch.device("meta"):
            super().__init__(layers, hidden, node_in, r_max)
            self.out_layer = readout_mlp(hidden, hidden // 2, n_bins)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        return self.out_layer(masked_node_pool(self._encode(g), g.node_mask))


class _EncoderPair(nn.Module):
    """MLPPhDOS's node and edge encoders, under the reference's names
    (GN_encoder.node_encoder, GN_encoder.edge_encoder)."""

    def __init__(self, node_in: int, edge_in: int, hidden: int):
        super().__init__()
        self.node_encoder = MLP2(node_in, hidden)
        self.edge_encoder = MLP2(edge_in, hidden)


class MLPPhDOS(nn.Module):
    """mlp_phonon (mlp_phonon.py:12-35), with the JAX package's intent
    fixes: the node features AND the one-hot types go through the one
    (shared) node encoder (:98-99); the readout is Linear(2h->h) of
    [pooled encoded types, pooled encoded nodes] (:136-141), kept as
    ``GN_decoder.mlp.0``; out_layer Linear(2h->h) -> LayerNorm -> PReLU ->
    Linear(h->1) per energy token (:20). The reference's edge encoder takes
    smooth_cutoff(|v| / r_max) * edge_shift (3 wide, :27-28) and its output
    is read by nothing: its parameters exist, it is not run."""

    EDGE_IN = 3

    def __init__(self, hidden: int = 256, n_bins: int = 51,
                 node_in: int = 118, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with torch.device("meta"):
            self.embeddings = nn.Embedding(n_bins, hidden)
            self.GN_encoder = _EncoderPair(node_in, self.EDGE_IN, hidden)
            self.GN_decoder = GraphDecoderEDOS(hidden)  # Linear(2h->h)
            self.out_layer = MLPBlock(2 * hidden, hidden, 1)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        encode = self.GN_encoder.node_encoder
        x = encode(g.nodes.float())
        z = encode(g.node_z.float())
        # [pooled types, pooled nodes], as GraphDecoderEDOS orders [u, x]
        graph = self.GN_decoder(x, masked_node_pool(z, g.node_mask),
                                g.node_mask)
        return energy_readout(self.embeddings, graph, self.out_layer)


class MLP2PhDOS(nn.Module):
    """mlp2_phonon (mlp_phonon.py:39-78; intent: the encoder called on nodes
    and edges): sum-pooled encoded nodes -> Linear(h->h) -> LeakyReLU ->
    Linear(h->bins) (:44, :75-77). The encoded edges are read by nothing,
    so only the node encoder runs."""

    def __init__(self, hidden: int = 256, n_bins: int = 51,
                 node_in: int = 118, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with torch.device("meta"):
            self.GN_encoder = GraphEncoderPhDOS(node_in, EDGE_FEATURES, hidden)
            self.out_layer = readout_mlp(hidden, hidden, n_bins)
        materialize_(self, device, generator)

    def forward(self, g: GraphBatch):
        x = self.GN_encoder.node_encoder(g.nodes.float())
        return self.out_layer(masked_node_pool(x, g.node_mask))
