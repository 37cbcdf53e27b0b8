"""eDOS featuriser: Materials Project records -> GraphSamples.

Counterpart of dostransformer_tpu/data/featurize_edos.py (the reference's
mat2graph.py pipeline), giving the same arrays bit for bit:

  * matscholar element embeddings (200 per element) in atomic-number order
    Z = 1..100, column-standardised as sklearn.preprocessing.scale does
    (mat2graph.py:33-47); the table ships with the package
    (``matscholar_embedding.npz``, the JAX package's file);
  * the 12 nearest neighbours within radius 8 of each atom, padded with
    (index 0, distance radius + 1) (mat2graph.py:212-243;
    :func:`~dostransformer_tpu_torch.data.neighbors.knn_edges`);
  * a Gaussian expansion of each distance, centres arange(0, 8.2, 0.2), 41
    wide (mat2graph.py:162-179);
  * one all-zero "prompt node" row appended per graph, with no edge
    (mat2graph.py:155-158);
  * y = y_ft / max(y_ft) (the training target), y_raw = y / max(y), y_max;
    glob = [energy_per_atom, formation_energy_per_atom]; band_gap; efermi;
    the crystal-system id 0..6 (mat2graph.py:80-107).

A record missing a field (``band_gap`` or ``efermi`` included) or whose
structure does not parse is dropped and counted as an error, as the
reference's per-record ``try`` does. ``workers > 1`` featurises on a process
pool (data/pool.py) with the same samples, order and error count.

    python -m dostransformer_tpu_torch.data.featurize_edos mp.pkl dos.pkl \\
        dos_dataset_random.npz [--workers 4]
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from dostransformer_tpu_torch import native
from dostransformer_tpu_torch.config import crystal_system_id
from dostransformer_tpu_torch.data.elements import SYMBOLS
from dostransformer_tpu_torch.data.sample import GraphSample
from dostransformer_tpu_torch.data.neighbors import knn_edges

N_MATSCHOLAR_ELEMENTS = 100  # Z = 1..100 (H..Fm), mat2graph.py:15-26


def standardize_columns(x: np.ndarray) -> np.ndarray:
    """sklearn.preprocessing.scale: per-column zero mean and unit population
    std (ddof=0); a zero-variance column is only centred."""
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd = np.where(sd == 0.0, 1.0, sd)
    return (x - mu) / sd


def load_matscholar_table() -> np.ndarray:
    """The bundled matscholar embeddings, unstandardised: [100, 200] f64,
    row Z-1 for Z = 1..100."""
    path = os.path.join(os.path.dirname(__file__), "matscholar_embedding.npz")
    with np.load(path) as npz:
        return np.asarray(npz["embeddings"], np.float64)


def load_elem_feats(path_elem_embs: Optional[str] = None) -> np.ndarray:
    """Element feature table, row Z-1 (mat2graph.py:33-47), standardised.

    ``None``: the bundled matscholar table -> [100, 200]. A path: a
    matscholar-format JSON ({symbol: [200 floats]}). ``"mendeleev"``: the
    reference's fallback without the JSON (mat2graph.py:36-38), 8 mendeleev
    properties and the first ionisation energy -> [100, 9]; it needs the
    ``mendeleev`` package."""
    if path_elem_embs is None:
        rows = load_matscholar_table()
    elif path_elem_embs == "mendeleev":
        return get_mendeleev_feats()
    else:
        with open(path_elem_embs) as f:
            embs = json.load(f)
        rows = np.vstack([np.asarray(embs[SYMBOLS[z]], np.float64)
                          for z in range(N_MATSCHOLAR_ELEMENTS)])
    return standardize_columns(rows)


def get_mendeleev_feats() -> np.ndarray:
    """The reference's fallback table (mat2graph.py:50-62): 8 tabulated
    element properties and the first ionisation energy, standardised."""
    try:
        from mendeleev import element
        from mendeleev.fetch import fetch_table
    except ImportError as e:
        raise RuntimeError(
            "the mendeleev table needs the `mendeleev` package; pass a "
            "matscholar embeddings JSON or use the bundled table") from e
    names = ["atomic_number", "period", "en_pauling", "covalent_radius_bragg",
             "electron_affinity", "atomic_volume", "atomic_weight",
             "fusion_heat"]
    tb = fetch_table("elements")[:N_MATSCHOLAR_ELEMENTS]
    feats = np.nan_to_num(np.array(tb[names], np.float64))
    ion = np.zeros((feats.shape[0], 1))
    for i in range(ion.shape[0]):
        ion[i, 0] = element(i + 1).ionenergies.get(1, 0.0)
    return standardize_columns(np.hstack([feats, ion]))


def gaussian_expand(distances: np.ndarray, dmin: float = 0.0,
                    dmax: float = 8.0, step: float = 0.2,
                    var: Optional[float] = None) -> np.ndarray:
    """Gaussian basis expansion (mat2graph.py:162-179)."""
    if var is None:
        var = step
    centers = np.arange(dmin, dmax + step, step)
    return np.exp(-((distances[..., None] - centers) ** 2) / var ** 2)


def build_sample(
    elem_feats: np.ndarray,
    numbers: Sequence[int],
    cart_coords: np.ndarray,
    lattice: np.ndarray,
    y: np.ndarray,
    y_ft: np.ndarray,
    glob: Sequence[float],
    crystal_system: str = "",
    band_gap: float = 0.0,
    efermi: float = 0.0,
    mp_id: str = "",
    sample_id: int = 0,
    radius: float = 8.0,
    max_num_nbr: int = 12,
) -> GraphSample:
    """One crystal -> GraphSample (mat2graph.py get_crystal_graph).
    ``coords`` [n_atoms, 3] and the one-hot ``z`` [n_atoms, 100] exclude the
    prompt node (one row fewer than x); no model reads them."""
    numbers = np.asarray(numbers, np.int64)
    cart_coords = np.asarray(cart_coords, np.float64)
    lattice = np.asarray(lattice, np.float64)

    x = elem_feats[numbers - 1]                        # [n, 200]
    x = np.vstack([x, np.zeros((1, x.shape[1]))])      # zero prompt node
    z_onehot = np.eye(100, dtype=np.float32)[numbers - 1]
    edge_index, dist = knn_edges(cart_coords, lattice, radius=radius,
                                 max_num_nbr=max_num_nbr)
    edge_attr = gaussian_expand(dist, dmax=radius)

    y = np.asarray(y, np.float64)
    y_ft = np.asarray(y_ft, np.float64)
    return GraphSample(
        x=x.astype(np.float32),
        edge_index=edge_index,
        edge_attr=edge_attr.astype(np.float32),
        coords=cart_coords.astype(np.float32),
        z=z_onehot,
        glob=np.asarray(glob, np.float32),
        y=(y_ft / y_ft.max()).astype(np.float32),      # the training target
        y_raw=(y / y.max()).astype(np.float32),
        y_max=float(y_ft.max()),
        band_gap=float(band_gap),
        efermi=float(efermi),
        system=crystal_system_id(crystal_system, phonon=False),
        mp_id=mp_id,
        sample_id=sample_id,
    )


def structure_from_cif(cif):
    """A record's structure -> (numbers, cart_coords, lattice), in the JAX
    package's order: a pre-parsed ``{"numbers", "cart_coords", "lattice"}``
    dict as it is; a CIF string through pymatgen where it is importable
    (the reference's path, mat2graph.py:121), else through the port's own
    reader (:mod:`~dostransformer_tpu_torch.data.cif`)."""
    if isinstance(cif, dict):
        return (np.asarray(cif["numbers"]), np.asarray(cif["cart_coords"]),
                np.asarray(cif["lattice"]))
    try:
        from pymatgen.core.structure import Structure
    except ImportError:
        from dostransformer_tpu_torch.data.cif import parse_cif

        d = parse_cif(cif)
        return d["numbers"], d["cart_coords"], d["lattice"]
    s = Structure.from_str(cif, fmt="cif")
    return (np.array(s.atomic_numbers), np.array(s.cart_coords),
            np.array(s.lattice.matrix))


# a worker's state, set by the pool's initializer (the serial path calls it
# too, so both run the same code)
_POOL_STATE: dict = {}


def _edos_pool_init(elem_feats, radius):
    _POOL_STATE["elem_feats"] = elem_feats
    _POOL_STATE["radius"] = radius


def _edos_pool_task(task):
    """One record -> GraphSample, or None when any field is missing or the
    structure does not parse (the reference's per-record ``try``). A fault
    of the native library is no record's fault: it raises."""
    i, mp_id, rec, dos_rec = task
    try:
        numbers, coords, lattice = structure_from_cif(rec["cif"])
        return build_sample(
            _POOL_STATE["elem_feats"], numbers, coords, lattice,
            y=np.asarray(dos_rec["densities_total_1"]),
            y_ft=np.asarray(dos_rec["densities_total_1_ft"]),
            glob=[rec["energy_per_atom"], rec["formation_energy_per_atom"]],
            crystal_system=rec["spacegroup"]["crystal_system"],
            # indexed, not .get(..., 0.0): a record without them is an error
            band_gap=rec["band_gap"], efermi=dos_rec["efermi"],
            mp_id=mp_id, sample_id=i, radius=_POOL_STATE["radius"])
    except native.NativeError:
        raise
    except Exception:
        return None


def load_dataset(
    mp_data: dict,
    dos_data: dict,
    original_dataset_mp_id: Sequence[str],
    path_elem_embs: Optional[str] = None,
    radius: float = 8.0,
    workers: int = 0,
) -> List[GraphSample]:
    """mp.pkl / dos.pkl-shaped dicts -> GraphSamples (mat2graph.py:69-117)
    of the records whose id is in ``original_dataset_mp_id``; a sample's id
    is its record's position in ``mp_data``, the records left out counted.
    ``workers > 1`` featurises on a spawn-context process pool. Unless
    ``DOSTPU_NO_NATIVE=1``, the native library is built (or loaded) first,
    so that a failed build raises before any record is read."""
    if native.enabled():
        native.library()
    elem_feats = load_elem_feats(path_elem_embs)
    keep = set(original_dataset_mp_id)
    tasks = [(i, mp_id, rec, dos_data.get(mp_id, {}))
             for i, (mp_id, rec) in enumerate(mp_data.items())
             if mp_id in keep]
    if workers and workers > 1:
        from dostransformer_tpu_torch.data.pool import host_pool

        with host_pool(workers, initializer=_edos_pool_init,
                       initargs=(elem_feats, radius)) as pool:
            results = pool.map(_edos_pool_task, tasks, chunksize=16)
    else:
        _edos_pool_init(elem_feats, radius)
        results = [_edos_pool_task(t) for t in tasks]
    out = [s for s in results if s is not None]
    print(f"Converted {len(out)} | errors {len(results) - len(out)}")
    return out


def main(argv=None):
    import argparse
    import pickle
    import time

    from dostransformer_tpu_torch.data.io import save_samples

    p = argparse.ArgumentParser("featurize_edos")
    p.add_argument("mp_pkl")
    p.add_argument("dos_pkl")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--elem_embs", default=None,
                   help="path to a matscholar-embedding.json (default: the "
                        "bundled matscholar table)")
    p.add_argument("--radius", type=float, default=8.0)
    p.add_argument("--workers", type=int, default=0,
                   help="featuriser process-pool size (0/1 = serial)")
    args = p.parse_args(argv)
    with open(args.mp_pkl, "rb") as f:
        mp_data = pickle.load(f)
    with open(args.dos_pkl, "rb") as f:
        dos_data = pickle.load(f)
    if native.enabled():
        native.library()  # a first build is not the featuriser's rate
    t0 = time.perf_counter()
    samples = load_dataset(mp_data, dos_data, list(mp_data.keys()),
                           args.elem_embs, radius=args.radius,
                           workers=args.workers)
    seconds = time.perf_counter() - t0
    save_samples(args.out, samples)
    print(f"featurized {len(samples)} crystals -> {args.out} "
          f"({len(mp_data) / seconds:.1f} records/s on the host)")


if __name__ == "__main__":
    main()
