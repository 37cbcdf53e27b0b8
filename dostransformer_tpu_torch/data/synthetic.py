"""Synthetic eDOS and phDOS samples for tests and benchmarks.

Counterpart of dostransformer_tpu/data/synthetic.py: the same numpy
RandomState draws in the same order, so a seed gives the same arrays in both
packages.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dostransformer_tpu_torch.data.graph import GraphSample


def synthetic_edos_samples(
    n_samples: int,
    seed: int = 0,
    min_atoms: int = 4,
    max_atoms: int = 24,
    n_atom_feats: int = 200,
    n_bond_feats: int = 41,
    max_num_nbr: int = 12,
    n_bins: int = 201,
) -> List[GraphSample]:
    """eDOS-style samples: matscholar-width node features plus one all-zero
    prompt-node row with no incident edges; each real atom has exactly
    max_num_nbr outgoing edges; Gaussian-expanded distances as edge
    features; glob = 2 features; y normalised to max 1."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_samples):
        n_atoms = int(rng.randint(min_atoms, max_atoms + 1))
        x = rng.randn(n_atoms, n_atom_feats).astype(np.float32)
        x = np.vstack([x, np.zeros((1, n_atom_feats), np.float32)])

        senders = np.repeat(np.arange(n_atoms), max_num_nbr)
        receivers = rng.randint(0, n_atoms, size=n_atoms * max_num_nbr)
        edge_index = np.stack([senders, receivers]).astype(np.int64)

        dists = rng.uniform(0.8, 8.0, size=n_atoms * max_num_nbr)
        centers = np.arange(0.0, 8.2, 0.2)
        edge_attr = np.exp(-((dists[:, None] - centers) ** 2)
                           / 0.2 ** 2).astype(np.float32)
        if edge_attr.shape[1] != n_bond_feats:
            raise ValueError(f"the Gaussian expansion has "
                             f"{edge_attr.shape[1]} centres, not "
                             f"n_bond_feats={n_bond_feats}")

        y = np.abs(rng.randn(n_bins)).astype(np.float32)
        y = y / y.max()
        out.append(GraphSample(
            x=x, edge_index=edge_index, edge_attr=edge_attr,
            glob=rng.randn(2).astype(np.float32),
            y=y, system=int(rng.randint(0, 7)), sample_id=i, mp_id=f"syn-{i}",
        ))
    return out


def synthetic_edos_learnable(n_samples: int, seed: int = 0,
                             **kwargs) -> List[GraphSample]:
    """eDOS samples whose targets are a deterministic smooth function of the
    graph's node features: a task whose loss can fall (the targets of
    :func:`synthetic_edos_samples` are noise)."""
    samples = synthetic_edos_samples(n_samples, seed=seed, **kwargs)
    rng = np.random.RandomState(seed + 1)
    n_bins = samples[0].y.shape[-1]
    w = rng.randn(samples[0].x.shape[1], 8) * 0.3
    centers = np.linspace(0, 1, 8)[None, :]
    grid = np.linspace(0, 1, n_bins)[:, None]
    for s in samples:
        feats = np.tanh(s.x[:-1].mean(axis=0) @ w)  # [8], without the prompt row
        mix = np.exp(-((grid - centers) ** 2) / 0.02) @ (feats + 1.1)
        y = np.abs(mix).astype(np.float32)
        s.y = y / y.max()
    return samples


def synthetic_phdos_samples(
    n_samples: int,
    seed: int = 0,
    min_atoms: int = 2,
    max_atoms: int = 12,
    n_bins: int = 51,
    r_max: float = 4.0,
) -> List[GraphSample]:
    """phDOS-style samples: 118-wide atomic-mass-row node features, edges
    with self-loops (zero vectors) and 4-9 random neighbours per atom at
    |v| < r_max, edge vectors and shifts, one-hot atom types; y normalised
    to max 1."""
    rng = np.random.RandomState(seed)
    masses = np.zeros((118, 118), np.float64)
    np.fill_diagonal(masses, np.linspace(1.0, 250.0, 118))
    out = []
    for i in range(n_samples):
        n_atoms = int(rng.randint(min_atoms, max_atoms + 1))
        zs = rng.randint(0, 118, size=n_atoms)
        x = masses[zs].astype(np.float32)

        per = int(rng.randint(4, 10))
        senders = np.concatenate([np.arange(n_atoms),
                                  np.repeat(np.arange(n_atoms), per)])
        receivers = np.concatenate([np.arange(n_atoms),
                                    rng.randint(0, n_atoms,
                                                size=n_atoms * per)])
        e = senders.shape[0]
        vec = rng.randn(e, 3)
        vec = vec / np.linalg.norm(vec, axis=1, keepdims=True) * rng.uniform(
            0.5, r_max * 0.99, size=(e, 1))
        vec[:n_atoms] = 0.0  # self-loops at zero shift
        y = np.abs(rng.randn(n_bins)).astype(np.float32)
        y = y / y.max()
        out.append(GraphSample(
            x=x, edge_index=np.stack([senders, receivers]).astype(np.int64),
            edge_vec=vec.astype(np.float32),
            edge_shift=rng.randn(e, 3).astype(np.float32),
            z=np.eye(118, dtype=np.float32)[zs],
            y=y, system=int(rng.randint(0, 7)), sample_id=i,
            mp_id=f"syn-ph-{i}",
        ))
    return out


def synthetic_phdos_learnable(n_samples: int, seed: int = 0,
                              **kwargs) -> List[GraphSample]:
    """phDOS samples whose 51-bin targets are a deterministic Gaussian
    mixture conditioned on the composition (mass spectrum): a task whose
    loss can fall."""
    samples = synthetic_phdos_samples(n_samples, seed=seed, **kwargs)
    rng = np.random.RandomState(seed + 1)
    n_bins = samples[0].y.shape[-1]
    grid = np.linspace(0, 1, n_bins)
    w = rng.randn(samples[0].x.shape[1], 4) * 0.5
    for s in samples:
        feats = np.tanh(s.x.mean(0) @ w)  # composition summary [4]
        centers = 0.2 + 0.6 * (feats + 1.0) / 2.0
        y = np.zeros_like(grid)
        for k, c in enumerate(centers):
            y += np.exp(-((grid - c) ** 2) / (0.01 + 0.005 * k))
        y = y.astype(np.float32)
        s.y = y / y.max()
    return samples
