"""Migration tool: the reference's featurised .pt datasets -> the npz format.

Counterpart of dostransformer_tpu/data/convert_reference_pt.py, writing the
same npz (data/io.py ``save_samples``, the format both packages read). The
reference keeps datasets as torch.save'd lists of PyG Data objects
(mat2graph.py:259; read at main_eDOS.py:42 as dos_dataset_random.pt /
train_ood_{crystal,element}.pt). Unpickling those needs torch_geometric;
this converter does without it: stub classes stand in for the
torch_geometric pickle paths while the file loads, and the known fields are
then searched for in the unpickled objects.

    python -m dostransformer_tpu_torch.data.convert_reference_pt IN.pt OUT.npz
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict, List, Optional

import numpy as np

from dostransformer_tpu_torch.data.graph import GraphSample

_FIELDS = ("x", "edge_index", "edge_attr", "y", "y_ft", "y_max", "glob",
           "band_gap", "efermi", "system", "mp_id", "coords", "z")


class _Stub:
    """Accepts any pickle state; stores it for generic extraction."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self._state = state


def _install_stubs() -> List[str]:
    """Register stub modules for torch_geometric pickle paths (only when the
    real package is absent). Returns the module names added."""
    added = []
    for mod in ("torch_geometric", "torch_geometric.data",
                "torch_geometric.data.data", "torch_geometric.data.storage",
                "torch_geometric.data.batch"):
        if mod not in sys.modules:
            m = types.ModuleType(mod)
            m.__getattr__ = lambda name: _Stub  # any class name -> stub
            sys.modules[mod] = m
            added.append(mod)
    return added


def _to_numpy(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def _extract_fields(obj: Any, out: Dict[str, Any], depth: int = 0) -> None:
    """Recursively harvest known field names from stubs/dicts."""
    if depth > 6 or obj is None:
        return
    d = obj if isinstance(obj, dict) else getattr(obj, "__dict__", None)
    if d is None:
        return
    for k, v in d.items():
        key = k.lstrip("_")
        if key in _FIELDS and key not in out and v is not None:
            out[key] = _to_numpy(v)
        elif isinstance(v, dict) or hasattr(v, "__dict__"):
            _extract_fields(v, out, depth + 1)


def convert(pt_path: str, out_path: Optional[str] = None) -> List[GraphSample]:
    import torch

    try:
        import torch_geometric  # noqa: F401
        added = []
    except ImportError:
        added = _install_stubs()
    try:
        data = torch.load(pt_path, map_location="cpu", weights_only=False)
    finally:
        for mod in added:
            del sys.modules[mod]

    samples: List[GraphSample] = []
    skipped = 0
    for i, item in enumerate(data):
        f: Dict[str, Any] = {}
        _extract_fields(item, f)
        if "x" not in f or "edge_index" not in f or "y_ft" not in f:
            skipped += 1
            continue
        samples.append(GraphSample(
            x=np.asarray(f["x"], np.float32),
            edge_index=np.asarray(f["edge_index"], np.int64),
            edge_attr=(np.asarray(f["edge_attr"], np.float32)
                       if "edge_attr" in f else None),
            y=np.asarray(f["y_ft"], np.float32).reshape(-1),
            y_raw=(np.asarray(f["y"], np.float32).reshape(-1)
                   if "y" in f else None),
            y_max=float(f["y_max"]) if "y_max" in f else None,
            glob=(np.asarray(f["glob"], np.float32).reshape(-1)
                  if "glob" in f else None),
            # reference Data carries coords [n_atoms, 3] and one-hot z
            # (mat2graph.py:143) — data fidelity, no model consumes them
            coords=(np.asarray(f["coords"], np.float32)
                    if "coords" in f else None),
            z=(np.asarray(f["z"], np.float32) if "z" in f else None),
            band_gap=float(f["band_gap"]) if "band_gap" in f else None,
            efermi=float(f["efermi"]) if "efermi" in f else None,
            system=int(f.get("system", 6)),
            mp_id=str(f.get("mp_id", i)),
            sample_id=i,
        ))
    print(f"converted {len(samples)} samples ({skipped} skipped)")
    if out_path:
        from dostransformer_tpu_torch.data.io import save_samples

        save_samples(out_path, samples)
        print(f"wrote {out_path}")
    return samples


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("convert_reference_pt")
    p.add_argument("pt_in")
    p.add_argument("npz_out")
    args = p.parse_args(argv)
    convert(args.pt_in, args.npz_out)


if __name__ == "__main__":
    main()
