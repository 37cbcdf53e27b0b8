"""On-disk dataset format: a list of GraphSamples in one compressed .npz.

Counterpart of dostransformer_tpu/data/io.py, with the same keys, so a file
written by either package loads in the other.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dostransformer_tpu_torch.data.sample import GraphSample

_OPTIONAL_FIELDS = ("edge_attr", "edge_vec", "edge_shift", "z", "coords",
                    "glob", "y_raw")
_SCALAR_FIELDS = ("system", "sample_id", "y_max", "band_gap", "efermi")


def save_samples(path, samples: List[GraphSample]) -> None:
    arrays = {"n_samples": np.array(len(samples))}
    for i, s in enumerate(samples):
        arrays[f"x_{i}"] = s.x
        arrays[f"edge_index_{i}"] = s.edge_index
        arrays[f"y_{i}"] = s.y
        arrays[f"mp_id_{i}"] = np.array(s.mp_id)
        for f in _OPTIONAL_FIELDS:
            v = getattr(s, f)
            if v is not None:
                arrays[f"{f}_{i}"] = v
        for f in _SCALAR_FIELDS:
            v = getattr(s, f)
            if v is not None:
                arrays[f"{f}_{i}"] = np.array(v)
    np.savez_compressed(path, **arrays)


def load_samples(path) -> List[GraphSample]:
    """Load a save_samples npz from a path or binary file-like object."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n_samples"])
        out = []
        for i in range(n):
            kw = {}
            for f in _OPTIONAL_FIELDS:
                if f"{f}_{i}" in z:
                    kw[f] = z[f"{f}_{i}"]
            for f in _SCALAR_FIELDS:
                if f"{f}_{i}" in z:
                    v = z[f"{f}_{i}"]
                    kw[f] = int(v) if f in ("system", "sample_id") else float(v)
            out.append(GraphSample(
                x=z[f"x_{i}"], edge_index=z[f"edge_index_{i}"], y=z[f"y_{i}"],
                mp_id=str(z[f"mp_id_{i}"]), **kw))
    return out
