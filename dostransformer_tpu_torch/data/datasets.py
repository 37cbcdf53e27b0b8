"""Fixed-shape batch loader for serving.

Counterpart of dostransformer_tpu/data/datasets.py `GraphLoader`, on its
non-shuffled path with bucketed shapes: batches in input order, every batch
padded to the same atom and edge slots (the samples' maxima, rounded to
padding buckets), and a short final batch padded with dummy graphs
(graph_mask 0) rather than dropped.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

from dostransformer_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    RequestError,
    bucket_size,
    collate,
)


class GraphLoader:
    """Fixed-shape batched iterator over GraphSamples, in input order."""

    def __init__(self, samples: Sequence[GraphSample], batch_size: int):
        self.samples = list(samples)
        self.batch_size = batch_size
        if not self.samples:
            raise RequestError("GraphLoader needs at least one sample")
        self.atoms_per_graph = bucket_size(
            max(s.n_nodes for s in self.samples))
        self.edges_per_graph = bucket_size(
            max(max(s.n_edges for s in self.samples), 1))

    def __len__(self) -> int:
        return math.ceil(len(self.samples) / self.batch_size)

    def __iter__(self) -> Iterator[GraphBatch]:
        bs = self.batch_size
        for i in range(0, len(self.samples), bs):
            yield collate(self.samples[i: i + bs],
                          atoms_per_graph=self.atoms_per_graph,
                          edges_per_graph=self.edges_per_graph,
                          num_graphs=bs)
