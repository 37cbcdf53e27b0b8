"""Seeded synthetic crystals with a size distribution, for the traffic mixes.

A copy of the port's ``data/synthetic.py`` generators (the same features:
eDOS 200-d node rows plus one all-zero prompt row, 12 outgoing edges an
atom with 41 Gaussian-expanded distances, 2 global features; phDOS 118-wide
atomic-mass rows, self-loops plus 4-9 neighbours an atom at |v| < r_max,
edge vectors and shifts, one-hot types), drawn in bulk rather than crystal
by crystal, with two changes for a benchmark:

  * the sizes are the quantiles of a log-uniform distribution of atom
    counts (:func:`quantile_sizes`), so every seed draws the same multiset
    of sizes and edge counts and only their order and the features change:
    the work of a run does not depend on the seed;
  * the seed is any whole number (``numpy.random.default_rng``).

The program receives only the ``GraphSample`` objects made here.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from dostransformer_tpu_torch.data.sample import GraphSample

EDOS_NODE_FEATS, EDOS_NEIGHBOURS = 200, 12
PHDOS_TYPES = 118
GAUSS_CENTRES = np.arange(0.0, 8.2, 0.2, dtype=np.float32)  # 41 centres


def quantile_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """The n mid-quantiles of a log-uniform distribution of whole numbers
    in [lo, hi]: floor(lo * ((hi + 1) / lo) ** ((i + 0.5) / n)), ascending."""
    q = (np.arange(n) + 0.5) / n
    sizes = np.floor(lo * np.exp(q * math.log((hi + 1) / lo)))
    return np.clip(sizes, lo, hi).astype(np.int64)


def _targets(rng: np.random.Generator, n: int, bins: int) -> np.ndarray:
    y = np.abs(rng.standard_normal((n, bins), dtype=np.float32))
    return y / y.max(axis=1, keepdims=True)


def edos_crystals(sizes: Sequence[int], rng: np.random.Generator,
                  bins: int = 201) -> List[GraphSample]:
    """eDOS crystals of the given atom counts, in that order."""
    sizes = np.asarray(sizes, np.int64)
    k = EDOS_NEIGHBOURS
    atoms = rng.standard_normal((int(sizes.sum()), EDOS_NODE_FEATS),
                                dtype=np.float32)
    n_edges = int(sizes.sum()) * k
    dists = rng.uniform(0.8, 8.0, n_edges).astype(np.float32)
    edge_attr = np.exp(-np.square(dists[:, None] - GAUSS_CENTRES)
                       / np.float32(0.04))
    receivers_u = rng.random(n_edges)
    ys = _targets(rng, len(sizes), bins)
    globs = rng.standard_normal((len(sizes), 2), dtype=np.float32)
    systems = rng.integers(0, 7, len(sizes))
    out, a0, e0 = [], 0, 0
    for i, n in enumerate(sizes.tolist()):
        x = np.zeros((n + 1, EDOS_NODE_FEATS), np.float32)  # + prompt row
        x[:n] = atoms[a0:a0 + n]
        e = n * k
        senders = np.repeat(np.arange(n), k)
        receivers = np.minimum((receivers_u[e0:e0 + e] * n).astype(np.int64),
                               n - 1)
        out.append(GraphSample(
            x=x, edge_index=np.stack([senders, receivers]),
            edge_attr=edge_attr[e0:e0 + e], glob=globs[i], y=ys[i],
            system=int(systems[i]), sample_id=i, mp_id=f"bench-{i}"))
        a0, e0 = a0 + n, e0 + e
    return out


def phdos_crystals(sizes: Sequence[int], neighbours: Sequence[int],
                   rng: np.random.Generator, bins: int = 51,
                   r_max: float = 4.0) -> List[GraphSample]:
    """phDOS crystals: atom counts ``sizes`` with ``neighbours[i]`` random
    neighbours an atom besides the self-loop."""
    masses = np.linspace(1.0, 250.0, PHDOS_TYPES).astype(np.float32)
    ys = _targets(rng, len(sizes), bins)
    systems = rng.integers(0, 7, len(sizes))
    out = []
    for i, (n, per) in enumerate(zip(np.asarray(sizes).tolist(),
                                     np.asarray(neighbours).tolist())):
        zs = rng.integers(0, PHDOS_TYPES, n)
        onehot = np.eye(PHDOS_TYPES, dtype=np.float32)[zs]
        senders = np.concatenate([np.arange(n), np.repeat(np.arange(n), per)])
        receivers = np.concatenate([np.arange(n),
                                    rng.integers(0, n, n * per)])
        e = senders.shape[0]
        vec = rng.standard_normal((e, 3))
        vec = (vec / np.linalg.norm(vec, axis=1, keepdims=True)
               * rng.uniform(0.5, r_max * 0.99, (e, 1)))
        vec[:n] = 0.0  # self-loops at zero shift
        out.append(GraphSample(
            x=onehot * masses[zs][:, None],
            edge_index=np.stack([senders, receivers]),
            edge_vec=vec.astype(np.float32),
            edge_shift=rng.standard_normal((e, 3), dtype=np.float32),
            z=onehot, y=ys[i], system=int(systems[i]),
            sample_id=i, mp_id=f"bench-ph-{i}"))
    return out


def crystals(task: str, mix: dict, count: int, rng: np.random.Generator,
             bins: int) -> List[GraphSample]:
    """``count`` crystals of a traffic mix's size distribution (its
    ``atoms`` and, for phDOS, ``neighbours`` ranges): the quantile sizes,
    in an order drawn from ``rng``."""
    lo, hi = mix["atoms"]
    order = rng.permutation(count)
    sizes = quantile_sizes(count, lo, hi)[order]
    if task == "edos":
        return edos_crystals(sizes, rng, bins)
    plo, phi = mix["neighbours"]
    per = (plo + np.arange(count) % (phi - plo + 1))[order]
    return phdos_crystals(sizes, per, rng, bins)
