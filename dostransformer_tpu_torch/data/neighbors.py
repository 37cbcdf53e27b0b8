"""Periodic neighbour search (NumPy, vectorised).

Counterpart of the NumPy path of dostransformer_tpu/data/neighbors.py
`neighbor_list_pbc`, which replaces ASE's ``neighbor_list("ijS", cutoff,
self_interaction=True)`` (reference utils.py:267). Offline host-side
preprocessing: the card never sees it. The JAX package's C++ search
(`dostransformer_tpu.native`) is not ported (ROADMAP.md queue 1 item 0).

Algorithm: enumerate the integer lattice shifts whose image cells can reach
a ``cutoff`` sphere (bound from the reciprocal-lattice plane spacings),
compute all pairwise displacements in one broadcast, and keep the pairs
whose SQUARED distance is below ``cutoff**2``, in (shift, i, j) order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _max_shifts(cell: np.ndarray, cutoff: float) -> np.ndarray:
    """Images needed per axis: ceil(cutoff / plane height), the height of
    the lattice planes normal to axis i being 1 / |inv(cell)[:, i]|."""
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
    return np.ceil(cutoff / heights).astype(np.int64)


def neighbor_list_pbc(
    positions: np.ndarray,
    cell: np.ndarray,
    cutoff: float,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    self_interaction: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ASE neighbor_list("ijS") semantics.

    positions [N, 3] cartesian; cell [3, 3] rows = lattice vectors. Returns
    (src [E], dst [E], shift [E, 3] int): every ordered pair with
    |pos[dst] - pos[src] + shift @ cell| < cutoff. ``self_interaction``
    keeps the zero-distance (i, i, S=0) pairs; periodic self-images
    (i, i, S != 0) are always kept, as in ASE. Positions outside the cell
    are wrapped for the search and the shifts re-expressed for the caller's
    coordinates."""
    positions = np.asarray(positions, np.float64)
    cell = np.asarray(cell, np.float64)
    n = positions.shape[0]

    frac = positions @ np.linalg.inv(cell)
    wrap = np.where(np.asarray(pbc, bool)[None, :],
                    np.floor(frac), 0.0).astype(np.int64)       # [N, 3]
    if wrap.any():
        search_pos = positions - wrap @ cell
    else:
        search_pos, wrap = positions, None

    nmax = _max_shifts(cell, cutoff)
    ranges = [np.arange(-m, m + 1) if p else np.array([0])
              for m, p in zip(nmax, pbc)]
    shifts = np.stack(np.meshgrid(*ranges, indexing="ij"),
                      axis=-1).reshape(-1, 3)
    shift_cart = shifts @ cell                                   # [S, 3]

    # d[s, i, j] = pos[j] + shift_s - pos[i]
    disp = (search_pos[None, None, :, :] + shift_cart[:, None, None, :]
            - search_pos[None, :, None, :])                      # [S, N, N, 3]
    mask = (disp ** 2).sum(axis=-1) < cutoff * cutoff
    if not self_interaction:
        zero_shift = np.all(shifts == 0, axis=1)                 # [S]
        mask &= ~(zero_shift[:, None, None] & np.eye(n, dtype=bool)[None])

    s_idx, i_idx, j_idx = np.nonzero(mask)
    src, dst, out = i_idx.astype(np.int64), j_idx.astype(np.int64), shifts[s_idx]
    if wrap is not None:
        # the search ran on pos_w[j] = pos[j] - wrap[j] @ cell
        out = out - wrap[dst] + wrap[src]
    return src, dst, out
