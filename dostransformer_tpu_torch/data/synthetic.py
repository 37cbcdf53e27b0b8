"""Synthetic eDOS and phDOS samples for tests and benchmarks.

Counterpart of dostransformer_tpu/data/synthetic.py: the same numpy
RandomState draws in the same order, so a seed gives the same arrays in both
packages. :func:`synthetic_mp_records` (the port's own) writes raw Materials
Project records instead, CIF strings and all, for the featurisers.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dostransformer_tpu_torch.data.elements import SYMBOLS
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


# space groups of the synthetic CIFs: (crystal system, symmetry operations)
_SPACE_GROUPS = (
    ("triclinic", ("x, y, z",)),
    ("triclinic", ("x, y, z", "-x, -y, -z")),
    ("monoclinic", ("x, y, z", "-x, y+1/2, -z+1/2", "-x, -y, -z",
                    "x, -y+1/2, z+1/2")),
)


def synthetic_mp_records(n_records: int, seed: int = 0, min_atoms: int = 4,
                         max_atoms: int = 24, n_bins: int = 201):
    """Materials-Project-shaped ``(mp_data, dos_data)`` dicts, as
    data/create_store.py writes mp.pkl and dos.pkl: each record's structure
    is a CIF string in pymatgen's CifWriter layout (P1, P-1 or P2_1/c; the
    last two list their symmetry operations, whose images the reader
    expands), with ``min_atoms`` to ``max_atoms`` atoms in the cell once
    expanded; energies, band gap, crystal system, and total DOS curves of
    ``n_bins`` bins with the Fermi level."""
    rng = np.random.RandomState(seed)
    mp_data, dos_data = {}, {}
    for i in range(n_records):
        system, ops = _SPACE_GROUPS[rng.randint(len(_SPACE_GROUPS))]
        per_site = len(ops)
        n_sites = int(rng.randint(-(-min_atoms // per_site),
                                  max_atoms // per_site + 1))
        a, b, c = rng.uniform(3.5, 7.0, 3)
        if system == "triclinic":
            alpha, beta, gamma = rng.uniform(80.0, 100.0, 3)
        else:
            alpha, beta, gamma = 90.0, rng.uniform(95.0, 110.0), 90.0
        numbers = rng.randint(1, 84, n_sites)
        # general positions: no site on a symmetry element, so each expands
        # to len(ops) distinct atoms
        frac = (rng.uniform(0.02, 0.48, (n_sites, 3))
                + 0.5 * rng.randint(0, 2, (n_sites, 3)))
        lines = [f"data_synthetic{i}",
                 f"_symmetry_space_group_name_H-M   'synthetic {system}'"]
        for tag, v in (("length_a", a), ("length_b", b), ("length_c", c),
                       ("angle_alpha", alpha), ("angle_beta", beta),
                       ("angle_gamma", gamma)):
            lines.append(f"_cell_{tag}   {v:.8f}")
        lines += ["loop_", " _symmetry_equiv_pos_site_id",
                  " _symmetry_equiv_pos_as_xyz"]
        lines += [f"  {k + 1}  '{op}'" for k, op in enumerate(ops)]
        lines += ["loop_", " _atom_site_type_symbol", " _atom_site_label",
                  " _atom_site_symmetry_multiplicity", " _atom_site_fract_x",
                  " _atom_site_fract_y", " _atom_site_fract_z",
                  " _atom_site_occupancy"]
        for k, (z, f) in enumerate(zip(numbers, frac)):
            sym = SYMBOLS[z - 1]
            lines.append(f"  {sym}  {sym}{k}  {per_site}  {f[0]:.8f}  "
                         f"{f[1]:.8f}  {f[2]:.8f}  1")
        mp_id = f"mp-{100000 + i}"
        mp_data[mp_id] = {
            "material_id": mp_id,
            "cif": "\n".join(lines) + "\n",
            "energy_per_atom": float(rng.uniform(-9.0, -1.0)),
            "formation_energy_per_atom": float(rng.uniform(-3.0, 0.5)),
            "spacegroup": {"crystal_system": system},
            "band_gap": float(abs(rng.randn())),
        }
        energies = np.linspace(-10.0, 10.0, n_bins)
        dos = np.abs(rng.randn(n_bins)) + np.exp(-energies ** 2 / 8.0)
        dos_data[mp_id] = {
            "densities_total_1": dos,
            "densities_total_1_ft": np.convolve(dos, np.ones(5) / 5, "same"),
            "efermi": float(rng.uniform(-2.0, 2.0)),
        }
    return mp_data, dos_data
