"""Device-resident training data: collate and upload once, batch on the
device.

Counterpart of dostransformer_tpu/train/device_dataset.py. The host loader
(data/datasets.py ``GraphLoader``) collates every batch on the host and
uploads it each step. For a training set that fits on the card (this
workload: a few GB at most) the samples are padded to the set's shapes ONCE,
uploaded ONCE, and every step gathers its batch on the device from the
resident tensors by a row of an index tensor [S, B] (``Trainer
.train_epoch_device``): no host collation and no upload after the first.

The shuffle order of an epoch is :func:`epoch_perm`: ``torch.randperm`` on
a CPU generator seeded by :func:`shuffle_seed` ``(seed, epoch[, bucket])``,
uploaded once an epoch. It cannot be the JAX package's order (threefry), but
like it, it depends on (seed, epoch) alone, so the card and the CPU see the
same order and a resumed run replays the uninterrupted run's order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from dostransformer_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    bucket_size,
    collate,
)
from dostransformer_tpu_torch.device import entry_device

# the fields a bf16 storage narrows: the large per-node and per-edge features
_FEATURES = ("nodes", "edges", "node_z")
_MIX = 1_000_003  # a prime, to spread (seed, epoch, bucket) over the seeds


def shuffle_seed(seed: int, epoch: int, bucket: Optional[int] = None) -> int:
    """The generator seed of epoch ``epoch`` (0 for the first) of a run
    seeded ``seed``, for the flat dataset (``bucket`` None) or for atom
    bucket number ``bucket`` (0 the smallest) of a bucketed one:
    ``(((seed ^ 0x5EED) * P + epoch) * P + k) mod 2**63`` with P = 1,000,003
    and k = 0 for the flat dataset, bucket + 1 otherwise. A pure function:
    resume replays the order."""
    k = 0 if bucket is None else bucket + 1
    return (((seed ^ 0x5EED) * _MIX + epoch) * _MIX + k) % (1 << 63)


def epoch_perm(num_samples: int, batch_size: int, seed: int, epoch: int,
               bucket: Optional[int] = None) -> torch.Tensor:
    """The epoch's sample order as [steps, batch_size] int64 on the CPU:
    ``torch.randperm(num_samples)`` from a CPU generator seeded by
    :func:`shuffle_seed` (``num_samples`` a multiple of ``batch_size``)."""
    g = torch.Generator().manual_seed(shuffle_seed(seed, epoch, bucket))
    return torch.randperm(num_samples, generator=g).reshape(-1, batch_size)


class DeviceDataset:
    """Every sample as one GraphBatch of N graphs on the device."""

    def __init__(self, data: GraphBatch, batch_size: int):
        if data.num_graphs % batch_size:
            raise ValueError(f"{data.num_graphs} graphs are no multiple of "
                             f"the batch size {batch_size}")
        self.data = data  # [N, ...]: every field sample-leading
        self.batch_size = batch_size

    @classmethod
    def from_samples(cls, samples: Sequence[GraphSample], batch_size: int,
                     atoms_per_graph: Optional[int] = None,
                     edges_per_graph: Optional[int] = None,
                     storage_dtype: Optional[torch.dtype] = None,
                     device="cuda") -> "DeviceDataset":
        """Collate on the host, then upload once. N is padded to a
        multiple of ``batch_size`` with dummy graphs (graph_mask 0): every
        sample is seen every epoch, and the masked loss ignores the dummies
        wherever the order puts them. ``storage_dtype`` (e.g.
        ``torch.bfloat16``) stores ``nodes``, ``edges`` and ``node_z`` in
        that type, halving the largest residents and the per-step gather;
        targets, masks, ``glob`` and the phDOS edge vectors stay f32, and
        the model widens its inputs back to f32. The data go to ``device``,
        the card by default (with no card visible this raises unless
        ``device="cpu"`` is given)."""
        device = entry_device(device)
        n = len(samples)
        n_pad = -(-n // batch_size) * batch_size
        data = collate(list(samples), atoms_per_graph=atoms_per_graph,
                       edges_per_graph=edges_per_graph, num_graphs=n_pad)
        if storage_dtype is not None:
            data = dataclasses.replace(data, **{
                name: getattr(data, name).to(storage_dtype)
                for name in _FEATURES if getattr(data, name) is not None})
        return cls(data.to(device), batch_size)

    @property
    def num_samples(self) -> int:
        """Graphs held, the dummies that pad N included."""
        return self.data.num_graphs

    @property
    def steps_per_epoch(self) -> int:
        return self.num_samples // self.batch_size

    @property
    def device(self) -> torch.device:
        return self.data.nodes.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in dataclasses.astuple(self.data) if t is not None)

    def batch(self, idx: torch.Tensor) -> GraphBatch:
        """The graphs ``idx`` [B] (a tensor on the data's device) as one
        batch, gathered on the device."""
        return dataclasses.replace(self.data, **{
            f.name: getattr(self.data, f.name).index_select(0, idx)
            for f in dataclasses.fields(self.data)
            if getattr(self.data, f.name) is not None})

    def perm(self, seed: int, epoch: int,
             bucket: Optional[int] = None) -> torch.Tensor:
        """:func:`epoch_perm` of this dataset (on the CPU)."""
        return epoch_perm(self.num_samples, self.batch_size, seed, epoch,
                          bucket)


class BucketedDeviceDataset:
    """The samples grouped by ATOM bucket (data/graph.py ``bucket_size``),
    one DeviceDataset per bucket, each padded only to its own bucket's
    shapes, so small crystals do not run at the largest one's padding.
    Each bucket is shuffled on its own every epoch (``bucket`` in
    :func:`shuffle_seed`) and batches are drawn within buckets, smallest
    bucket first; every sample is still seen once an epoch."""

    def __init__(self, buckets):
        self.buckets = buckets  # [(atom bucket, DeviceDataset)], ascending

    @classmethod
    def from_samples(cls, samples: Sequence[GraphSample], batch_size: int,
                     storage_dtype: Optional[torch.dtype] = None,
                     device="cuda") -> "BucketedDeviceDataset":
        groups: dict = {}
        for s in samples:
            groups.setdefault(bucket_size(s.n_nodes), []).append(s)
        return cls([(a, DeviceDataset.from_samples(
            group, batch_size, storage_dtype=storage_dtype, device=device))
            for a, group in sorted(groups.items())])

    @property
    def batch_size(self) -> int:
        return self.buckets[0][1].batch_size

    @property
    def steps_per_epoch(self) -> int:
        return sum(d.steps_per_epoch for _, d in self.buckets)

    @property
    def num_samples(self) -> int:
        return sum(d.num_samples for _, d in self.buckets)

    def nbytes(self) -> int:
        return sum(d.nbytes() for _, d in self.buckets)
