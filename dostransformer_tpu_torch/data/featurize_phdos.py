"""phDOS featuriser: phononDoS data.csv -> GraphSamples.

Counterpart of dostransformer_tpu/data/featurize_phdos.py `build_sample` and
`featurize_csv` (the reference's `load_data` + `build_data`,
utils.py:152-173, 249-303), giving the same arrays:

  * node features: row Z-1 of diag(atomic_mass) (118 wide); z: one-hot type;
  * edges: :func:`~dostransformer_tpu_torch.data.neighbors.neighbor_list_pbc`
    within r_max, self-loops included, with edge_vec = pos[dst] - pos[src]
    + shift @ cell (utils.py:267-273);
  * target ``phdos`` [51]; crystal-system id 0..6 (utils.py:277-290).

The CSV is read with the standard library's ``csv`` module (the machine
with the card has no pandas), giving what ``pandas.read_csv`` gives for these
columns: quoted fields, a row's position as its index, and an empty cell
read as pandas' NaN ("nan"), so an empty ``crystal_system`` maps to id 6.
Structures are ASE ``Atoms.todict()`` reprs, parsed with ``ast.literal_eval``.
``workers > 1`` (``--workers``) featurises on a process pool (data/pool.py)
with the same samples, order and species as the serial path.

    python -m dostransformer_tpu_torch.data.featurize_phdos data.csv out.npz \
        [--workers 4]
"""

from __future__ import annotations

import ast
import csv
from typing import List, Sequence, Tuple

import numpy as np

from dostransformer_tpu_torch.config import crystal_system_id
from dostransformer_tpu_torch.data.elements import (
    SYMBOLS,
    atomic_mass_features,
    one_hot_types,
)
from dostransformer_tpu_torch.data.sample import GraphSample
from dostransformer_tpu_torch.data.neighbors import neighbor_list_pbc


def build_sample(
    numbers: Sequence[int],
    positions: np.ndarray,
    cell: np.ndarray,
    phdos: np.ndarray,
    crystal_system: str = "",
    mp_id: str = "",
    sample_id: int = 0,
    r_max: float = 4.0,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
) -> GraphSample:
    """One crystal -> GraphSample (reference build_data, utils.py:249-303)."""
    numbers = np.asarray(numbers, np.int64)
    positions = np.asarray(positions, np.float64)
    cell = np.asarray(cell, np.float64)
    src, dst, shifts = neighbor_list_pbc(positions, cell, r_max, pbc=pbc,
                                         self_interaction=True)
    edge_vec = positions[dst] - positions[src] + shifts @ cell
    return GraphSample(
        x=atomic_mass_features(numbers).astype(np.float32),
        z=one_hot_types(numbers).astype(np.float32),
        edge_index=np.stack([src, dst]),
        edge_vec=edge_vec.astype(np.float32),
        edge_shift=shifts.astype(np.float32),
        y=np.asarray(phdos, np.float32).reshape(-1),
        system=crystal_system_id(crystal_system, phonon=True),
        mp_id=mp_id,
        sample_id=sample_id,
    )


def _atoms_from_dict(d: dict):
    """Parse an ASE Atoms.todict() payload: numbers, positions, cell, pbc."""
    numbers = np.asarray(d["numbers"], np.int64)
    positions = np.asarray(d["positions"], np.float64)
    cell = np.asarray(d["cell"], np.float64)
    pbc = tuple(bool(b) for b in np.atleast_1d(d.get("pbc", True)).tolist())
    if len(pbc) == 1:
        pbc = pbc * 3
    if len(pbc) != 3:
        raise ValueError(f"pbc must have 1 or 3 entries, got {len(pbc)}")
    return numbers, positions, cell, pbc


def _cell(row: dict, column: str, default: str) -> str:
    """A column's value as ``str(pandas_value)`` gives it: the default when
    the column is absent, "nan" for an empty cell."""
    if column not in row:
        return default
    value = row[column]
    return "nan" if value is None or value == "" else value


# a worker's state, set by the pool's initializer (the serial path calls it
# too, so both run the same code)
_POOL_STATE: dict = {}


def _phdos_pool_init(r_max):
    _POOL_STATE["r_max"] = r_max


def _phdos_pool_task(task):
    """One CSV row -> (GraphSample, its sorted element symbols)."""
    i, structure_str, phdos_str, crystal_system, mp_id = task
    numbers, positions, cell, pbc = _atoms_from_dict(
        ast.literal_eval(structure_str))
    phdos = np.asarray(ast.literal_eval(phdos_str), np.float64)
    sample = build_sample(
        numbers, positions, cell, phdos, crystal_system=crystal_system,
        mp_id=mp_id, sample_id=i, r_max=_POOL_STATE["r_max"], pbc=pbc)
    return sample, sorted({SYMBOLS[z - 1] for z in numbers})


def featurize_csv(path: str, r_max: float = 4.0, workers: int = 0
                  ) -> Tuple[List[GraphSample], List[List[str]]]:
    """data.csv -> (samples, species_per_sample).

    The CSV carries ``structure`` as the repr of an ASE Atoms dict, plus
    ``phdos``, ``crystal_system`` and ``mp_id`` columns (reference
    utils.py:152-173; ``phfreq`` and ``pdos`` are not read).
    species_per_sample feeds :func:`~dostransformer_tpu_torch.data.datasets.
    element_balanced_split`. A malformed row raises. ``workers > 1``
    featurises on a spawn-context process pool."""
    with open(path, newline="") as f:
        tasks = [(i, row["structure"], row["phdos"],
                  _cell(row, "crystal_system", ""),
                  _cell(row, "mp_id", str(i)))
                 for i, row in enumerate(csv.DictReader(f))]
    if workers and workers > 1:
        from dostransformer_tpu_torch.data.pool import host_pool

        with host_pool(workers, initializer=_phdos_pool_init,
                       initargs=(r_max,)) as pool:
            results = pool.map(_phdos_pool_task, tasks, chunksize=16)
    else:
        _phdos_pool_init(r_max)
        results = [_phdos_pool_task(t) for t in tasks]
    return [s for s, _ in results], [sp for _, sp in results]


def main(argv=None):
    import argparse
    import time

    from dostransformer_tpu_torch.data.io import save_samples

    p = argparse.ArgumentParser("featurize_phdos")
    p.add_argument("csv")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--r_max", type=float, default=4.0)
    p.add_argument("--workers", type=int, default=0,
                   help="featuriser process-pool size (0/1 = serial)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    samples, _ = featurize_csv(args.csv, r_max=args.r_max,
                               workers=args.workers)
    seconds = time.perf_counter() - t0
    save_samples(args.out, samples)
    print(f"featurized {len(samples)} crystals -> {args.out} "
          f"({len(samples) / seconds:.1f} crystals/s on the host)")


if __name__ == "__main__":
    main()
