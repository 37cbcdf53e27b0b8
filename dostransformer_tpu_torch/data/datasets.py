"""Dataset splits and the fixed-shape batch loader.

Counterpart of dostransformer_tpu/data/datasets.py:

  * :func:`train_test_split` is sklearn's shuffled split without sklearn
    (the card's machine has none): ``RandomState(random_state)
    .permutation(n)``, the first ``ceil(n * test_size)`` indices to test,
    the rest to train, the order sklearn gives;
  * :func:`edos_random_split` (80/10/10, main_eDOS.py:42-48) and
    :func:`edos_ood_split` (valid/test = halves of the OOD test set,
    main_eDOS.py:34-39);
  * :func:`read_index_file` (phDOS's idx_{train,valid,test}.txt,
    main_phDOS.py:47-49) and :func:`element_balanced_split`, the reference's
    splitter that writes them (utils.py:176-245), order for order;
  * :class:`GraphLoader`: every batch padded to the same atom and edge slots
    (the samples' maxima rounded to padding buckets, or pinned), a short
    final batch padded with dummy graphs (graph_mask 0) unless dropped, and
    an optional shuffle from one ``RandomState(seed)`` that advances every
    epoch, so a seed gives the JAX host loader's batches.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

from dostransformer_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    RequestError,
    bucket_size,
    collate,
)


def train_test_split(items: Sequence, test_size: float, random_state: int):
    """sklearn.model_selection.train_test_split(shuffle=True) order: returns
    (train, test) lists."""
    items = list(items)
    n = len(items)
    n_test = int(math.ceil(n * test_size))
    if n_test >= n or n_test < 1:
        raise ValueError(f"train_test_split would leave an empty split "
                         f"(n={n}, n_test={n_test})")
    perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def edos_random_split(dataset: Sequence[GraphSample], random_state: int = 0):
    """80/10/10 (main_eDOS.py:42-48): split off 20%, then halve it."""
    train, rest = train_test_split(dataset, 0.2, random_state)
    valid, test = train_test_split(rest, 0.5, random_state)
    return train, valid, test


def edos_ood_split(train_dataset, test_dataset, random_state: int = 0):
    """OOD splits (main_eDOS.py:34-39): valid/test = halves of the OOD test
    set."""
    valid, test = train_test_split(test_dataset, 0.5, random_state)
    return list(train_dataset), valid, test


def read_index_file(path: str) -> List[int]:
    """idx_{train,valid,test}.txt reader (main_phDOS.py:47-49)."""
    with open(path) as f:
        return [int(line.split("\n")[0]) for line in f.readlines()]


def element_balanced_split(species_per_sample: Sequence[Sequence[str]],
                           valid_size: float = 0.1, test_size: float = 0.1,
                           seed: int = 12):
    """Element-balanced train/valid/test index lists (utils.py:176-194):
    for each element, by sample count ascending, split its sample indices
    with :func:`train_test_split` and keep only indices not yet assigned;
    leftovers go to train. Count ties break in numpy quicksort order over
    the alphabetical species table, as the reference's pandas
    ``sort_values('count')`` breaks them; an element with too few samples to
    split is skipped (utils.py:230-233)."""
    species = sorted({sp for row in species_per_sample for sp in row})
    all_idx = list(range(len(species_per_sample)))

    def split_level(universe: List[int], frac: float):
        stats = []
        for sp in species:
            members = [i for i in universe if sp in species_per_sample[i]]
            if members:
                stats.append(members)
        order = np.argsort(np.array([len(m) for m in stats]),
                           kind="quicksort")
        idx_train: List[int] = []
        idx_test: List[int] = []
        for j in order:
            try:
                tr, te = train_test_split(stats[j], frac, seed)
            except ValueError:
                continue
            assigned = set(idx_train) | set(idx_test)
            idx_train += [k for k in tr
                          if k not in assigned and k not in idx_train]
            assigned = set(idx_train) | set(idx_test)
            idx_test += [k for k in te
                         if k not in assigned and k not in idx_test]
        return idx_train, idx_test

    dev_size = valid_size + test_size
    idx_train, idx_dev = split_level(all_idx, dev_size)
    idx_valid, idx_test = split_level(idx_dev, test_size / dev_size)
    assigned = set(idx_train) | set(idx_valid) | set(idx_test)
    idx_train += [i for i in all_idx if i not in assigned]
    return idx_train, idx_valid, idx_test


class GraphLoader:
    """Fixed-shape batched iterator over GraphSamples (CPU tensors)."""

    def __init__(self, samples: Sequence[GraphSample], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 atoms_per_graph: Optional[int] = None,
                 edges_per_graph: Optional[int] = None,
                 drop_last: bool = False):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        if not self.samples:
            raise RequestError("GraphLoader needs at least one sample")
        self.atoms_per_graph = (
            atoms_per_graph if atoms_per_graph is not None
            else bucket_size(max(s.n_nodes for s in self.samples)))
        self.edges_per_graph = (
            edges_per_graph if edges_per_graph is not None
            else bucket_size(max(max(s.n_edges for s in self.samples), 1)))

    def __len__(self) -> int:
        n = len(self.samples)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs):
            yield collate([self.samples[j] for j in order[i: i + bs]],
                          atoms_per_graph=self.atoms_per_graph,
                          edges_per_graph=self.edges_per_graph,
                          num_graphs=bs)
