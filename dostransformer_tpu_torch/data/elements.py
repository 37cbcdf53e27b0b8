"""Element tables: symbols and standard atomic masses for Z = 1..118.

Counterpart of dostransformer_tpu/data/elements.py (the same values), which
replaces the reference's ASE `Atom(Z).mass` (utils.py:258) and its
hard-coded symbol table (mat2graph.py:15-26). Masses are IUPAC standard
atomic weights, the convention of ASE's ``ase.data.atomic_masses``.
"""

from __future__ import annotations

import numpy as np

SYMBOLS = (
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
)

ATOMIC_MASSES = np.array([
    1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078, 44.955908,
    47.867, 50.9415, 51.9961, 54.938044, 55.845, 58.933194, 58.6934,
    63.546, 65.38, 69.723, 72.630, 74.921595, 78.971, 79.904, 83.798,
    85.4678, 87.62, 88.90584, 91.224, 92.90637, 95.95, 97.90721, 101.07,
    102.90550, 106.42, 107.8682, 112.414, 114.818, 118.710, 121.760,
    127.60, 126.90447, 131.293, 132.90545196, 137.327, 138.90547,
    140.116, 140.90766, 144.242, 144.91276, 150.36, 151.964, 157.25,
    158.92535, 162.500, 164.93033, 167.259, 168.93422, 173.054,
    174.9668, 178.49, 180.94788, 183.84, 186.207, 190.23, 192.217,
    195.084, 196.966569, 200.592, 204.38, 207.2, 208.98040, 208.98243,
    209.98715, 222.01758, 223.01974, 226.02541, 227.02775, 232.0377,
    231.03588, 238.02891, 237.04817, 244.06421, 243.06138, 247.07035,
    247.07031, 251.07959, 252.0830, 257.09511, 258.09843, 259.1010,
    262.110, 267.122, 268.126, 271.134, 270.133, 269.1338, 278.156,
    281.165, 282.169, 285.177, 286.182, 289.190, 289.194, 293.204,
    294.211, 294.214,
], dtype=np.float64)

SYMBOL_TO_Z = {s: z + 1 for z, s in enumerate(SYMBOLS)}


def atomic_mass_features(numbers: np.ndarray) -> np.ndarray:
    """phDOS node features: row Z-1 of diag(atomic_mass) over Z=1..118 —
    a one-hot scaled by the element's mass (reference utils.py:254-262,293)."""
    numbers = np.asarray(numbers, dtype=np.int64)
    out = np.zeros((numbers.shape[0], 118), dtype=np.float64)
    out[np.arange(numbers.shape[0]), numbers - 1] = ATOMIC_MASSES[numbers - 1]
    return out


def one_hot_types(numbers: np.ndarray, n_types: int = 118) -> np.ndarray:
    """One-hot atom-type features (reference utils.py:294; eDOS uses 100
    classes, mat2graph.py:199-201)."""
    numbers = np.asarray(numbers, dtype=np.int64)
    return np.eye(n_types, dtype=np.float64)[numbers - 1]
