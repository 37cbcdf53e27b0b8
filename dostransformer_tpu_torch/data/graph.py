"""Fixed-shape padded graph batches (torch tensors).

Counterpart of dostransformer_tpu/data/graph.py: the same batch-leading
layout with fixed per-graph node and edge slots,

    nodes      [B, A, Fx]   A node slots per graph
    senders    [B, Eg]      Eg edge slots per graph, LOCAL indices in [0, A)
    receivers  [B, Eg]
    node_mask  [B, A]       1 for real atoms
    edge_mask  [B, Eg]      1 for real edges

and the same pad semantics: pad node rows are zero with node_mask 0, pad
edges have senders/receivers 0 and edge_mask 0, dummy graphs of a short
batch have graph_mask 0 and sample_id -1. :func:`collate` produces arrays
identical to the JAX package's ``collate(..., numpy=True)``, as CPU tensors;
``GraphBatch.to(device)`` uploads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from dostransformer_tpu_torch.data.sample import GraphSample


class RequestError(ValueError):
    """Invalid INPUT data: a serving request (or collate pin) that violates
    the batch contract — empty, over the shape envelope, or schema-mixed.
    A ValueError, so callers' handlers for bad input keep working."""


@dataclasses.dataclass
class GraphBatch:
    """Fixed-shape batch of B graphs; every field is batch-leading."""

    nodes: torch.Tensor        # [B, A, Fx] float32
    senders: torch.Tensor      # [B, Eg] int32, local node index
    receivers: torch.Tensor    # [B, Eg] int32
    node_mask: torch.Tensor    # [B, A] float32
    edge_mask: torch.Tensor    # [B, Eg] float32
    y: torch.Tensor            # [B, bins]
    system: torch.Tensor       # [B] int32
    graph_mask: torch.Tensor   # [B] float32 (0 for dummy graphs)
    sample_id: torch.Tensor    # [B] int32
    edges: Optional[torch.Tensor] = None       # [B, Eg, Fe] eDOS
    edge_vec: Optional[torch.Tensor] = None    # [B, Eg, 3] phDOS
    edge_shift: Optional[torch.Tensor] = None  # [B, Eg, 3] phDOS
    glob: Optional[torch.Tensor] = None        # [B, Fg] eDOS
    node_z: Optional[torch.Tensor] = None      # [B, A, Fz] phDOS

    @property
    def num_graphs(self) -> int:
        return self.nodes.shape[0]

    @property
    def atoms_per_graph(self) -> int:
        return self.nodes.shape[1]

    @property
    def edges_per_graph(self) -> int:
        return self.senders.shape[1]

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


def bucket_size(n: int, minimum: int = 8) -> int:
    """Padding bucket: powers of two up to 128, then multiples of 128 (as in
    the JAX package, so both pad a request to the same shapes)."""
    m = minimum
    while m < n and m < 128:
        m *= 2
    if n <= m:
        return m
    return -(-n // 128) * 128


def collate(
    samples: Sequence[GraphSample],
    atoms_per_graph: Optional[int] = None,
    edges_per_graph: Optional[int] = None,
    num_graphs: Optional[int] = None,
    use_buckets: bool = True,
) -> GraphBatch:
    """Collate host-side samples into one fixed-shape GraphBatch of CPU
    tensors.

    atoms_per_graph / edges_per_graph / num_graphs may be pinned or derived
    per batch via the padding buckets; a pin below what the samples need,
    an empty request or a batch that mixes feature schemas raises
    RequestError."""
    b_real = len(samples)
    if b_real == 0:
        raise RequestError("empty request: no samples to collate")
    b = b_real if num_graphs is None else num_graphs
    if b < b_real:
        raise RequestError(
            f"{b_real} samples but the pinned num_graphs is {b} — the "
            f"request exceeds the shape envelope")

    max_n = max(s.n_nodes for s in samples)
    max_e = max(s.n_edges for s in samples)
    a = (atoms_per_graph if atoms_per_graph is not None
         else (bucket_size(max_n) if use_buckets else max_n))
    eg = (edges_per_graph if edges_per_graph is not None
          else (bucket_size(max(max_e, 1)) if use_buckets else max(max_e, 1)))
    if a < max_n:
        raise RequestError(
            f"sample has {max_n} atoms but the pinned atoms_per_graph "
            f"bucket is {a} — the request exceeds the shape envelope")
    if eg < max_e:
        raise RequestError(
            f"sample has {max_e} edges but the pinned edges_per_graph "
            f"bucket is {eg} — the request exceeds the shape envelope")

    fx = samples[0].x.shape[1]
    bins = samples[0].y.shape[-1]
    s0 = samples[0]
    for i, s in enumerate(samples[1:], 1):
        for name in ("edge_attr", "edge_vec", "edge_shift", "z", "glob"):
            if (getattr(s, name) is None) != (getattr(s0, name) is None):
                have = "has" if getattr(s0, name) is not None else "lacks"
                raise RequestError(
                    f"inconsistent batch: sample 0 {have} {name} but "
                    f"sample {i} does not match — all samples in one "
                    f"request must share the same feature schema")
        if s.x.shape[1] != fx:
            raise RequestError(
                f"inconsistent batch: sample 0 has {fx}-d node features "
                f"but sample {i} has {s.x.shape[1]}-d")
        if s.y.shape[-1] != bins:
            raise RequestError(
                f"inconsistent batch: sample 0 has {bins} energy bins "
                f"but sample {i} has {s.y.shape[-1]}")

    def pack(arrays, rows):
        out = np.zeros((b, rows) + arrays[0].shape[1:], np.float32)
        for g, arr in enumerate(arrays):
            out[g, : arr.shape[0]] = arr
        return out

    def optional(name, rows):
        if getattr(s0, name) is None:
            return None
        return pack([getattr(s, name) for s in samples], rows)

    n_rows = np.array([s.n_nodes for s in samples], np.int64)
    e_rows = np.array([s.n_edges for s in samples], np.int64)
    nodes = pack([s.x for s in samples], a)
    node_mask = np.zeros((b, a), np.float32)
    node_mask[:b_real] = np.arange(a)[None] < n_rows[:, None]
    senders = np.zeros((b, eg), np.int32)
    receivers = np.zeros((b, eg), np.int32)
    for g, s in enumerate(samples):
        senders[g, : s.n_edges] = s.edge_index[0]
        receivers[g, : s.n_edges] = s.edge_index[1]
    edge_mask = np.zeros((b, eg), np.float32)
    edge_mask[:b_real] = np.arange(eg)[None] < e_rows[:, None]
    y = np.zeros((b, bins), np.float32)
    y[:b_real] = np.stack([np.asarray(s.y, np.float32).reshape(-1)
                           for s in samples])
    system = np.zeros((b,), np.int32)
    system[:b_real] = [s.system for s in samples]
    graph_mask = np.zeros((b,), np.float32)
    graph_mask[:b_real] = 1.0
    sample_id = np.full((b,), -1, np.int32)
    sample_id[:b_real] = [s.sample_id for s in samples]
    glob = None
    if s0.glob is not None:
        glob = np.zeros((b, s0.glob.shape[-1]), np.float32)
        glob[:b_real] = np.stack([np.asarray(s.glob, np.float32)
                                  for s in samples])
    # z is a per-node model input only where it row-aligns with x (phDOS);
    # the eDOS z has one row fewer (the prompt node has no type) and stays a
    # sample-level field, as in the JAX package
    node_z = (pack([s.z for s in samples], a)
              if s0.z is not None and s0.z.shape[0] == s0.x.shape[0]
              else None)

    t = lambda x: torch.from_numpy(x) if x is not None else None
    return GraphBatch(
        nodes=t(nodes), senders=t(senders), receivers=t(receivers),
        node_mask=t(node_mask), edge_mask=t(edge_mask), y=t(y),
        system=t(system), graph_mask=t(graph_mask), sample_id=t(sample_id),
        edges=t(optional("edge_attr", eg)), edge_vec=t(optional("edge_vec", eg)),
        edge_shift=t(optional("edge_shift", eg)), glob=t(glob),
        node_z=t(node_z))
