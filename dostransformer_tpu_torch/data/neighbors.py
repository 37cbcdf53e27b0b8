"""Periodic neighbour search.

Counterpart of dostransformer_tpu/data/neighbors.py: `neighbor_list_pbc`
replaces ASE's ``neighbor_list("ijS", cutoff, self_interaction=True)``
(reference utils.py:267), `get_all_neighbors` pymatgen's
``Structure.get_all_neighbors(radius, include_index=True)`` and `knn_edges`
the eDOS 12-NN edges built on it (reference mat2graph.py:193, 212-243).
Offline host-side preprocessing: the card never sees it.

The search runs in the C++ library (dostransformer_tpu_torch.native) unless
``DOSTPU_NO_NATIVE=1`` asks for the NumPy version below. Both enumerate the
integer lattice shifts whose image cells can reach a ``cutoff`` sphere
(bound from the reciprocal-lattice plane spacings), then the pairs (i, j) in
(shift, i, j) order, and keep those whose SQUARED distance is below
``cutoff**2``: the same pairs in the same order, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dostransformer_tpu_torch import native


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

    def adjust(src, dst, out):
        if wrap is not None:
            # the search ran on pos_w[j] = pos[j] - wrap[j] @ cell
            out = out - wrap[dst] + wrap[src]
        return src, dst, out

    if native.enabled():
        return adjust(*native.neighbor_list(search_pos, cell, cutoff, pbc,
                                            self_interaction))

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
    return adjust(i_idx.astype(np.int64), j_idx.astype(np.int64),
                  shifts[s_idx])


def _distances(positions, cell, radius):
    """Pairs within ``radius`` without the zero-distance self pairs, and
    their distances."""
    src, dst, shifts = neighbor_list_pbc(positions, cell, radius,
                                         self_interaction=False)
    cell = np.asarray(cell, np.float64)
    vec = positions[dst] + shifts @ cell - positions[src]
    return src, dst, np.linalg.norm(vec, axis=1)


def get_all_neighbors(positions: np.ndarray, cell: np.ndarray,
                      radius: float) -> list:
    """pymatgen ``get_all_neighbors(radius, include_index=True)``
    semantics: for each site i, its (distance, neighbour index) pairs over
    every periodic image within ``radius``, without the site itself at
    distance 0 (its periodic images are kept)."""
    positions = np.asarray(positions, np.float64)
    src, dst, dist = _distances(positions, cell, radius)
    out = [[] for _ in range(positions.shape[0])]
    for s, d, r in zip(src, dst, dist):
        out[s].append((float(r), int(d)))
    return out


def knn_edges(positions: np.ndarray, cell: np.ndarray, radius: float = 8.0,
              max_num_nbr: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """The eDOS 12-NN edges (reference mat2graph.py:212-243): per atom its
    neighbours within ``radius`` sorted by distance, truncated to
    ``max_num_nbr`` or padded with (index 0, distance radius + 1). Returns
    (edge_index [2, N * max_num_nbr] with rows (center, neighbour), dist
    [N * max_num_nbr]).

    The order is a stable sort by (center, distance): equal distances keep
    the search's (shift, i, j) order, as in the JAX package."""
    positions = np.asarray(positions, np.float64)
    src, dst, d = _distances(positions, cell, radius)
    n = positions.shape[0]
    order = np.lexsort((d, src))
    src_s, dst_s, d_s = src[order], dst[order], d[order]
    counts = np.bincount(src_s, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(src_s.shape[0]) - starts[src_s]
    keep = rank < max_num_nbr
    idx = np.zeros((n, max_num_nbr), np.int64)
    dist = np.full((n, max_num_nbr), radius + 1.0, np.float64)
    idx[src_s[keep], rank[keep]] = dst_s[keep]
    dist[src_s[keep], rank[keep]] = d_s[keep]
    edge_index = np.stack([np.repeat(np.arange(n), max_num_nbr),
                           idx.reshape(-1)])
    return edge_index, dist.reshape(-1)
