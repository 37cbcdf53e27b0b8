"""Eval-artifact export: predictions, targets, graph embeddings.

Counterpart of dostransformer_tpu/train/artifacts.py. The reference's
``test`` loop returns (mp_id, preds, y, graph embeddings) per sample
(utils.py:93-109) and its training script drops them; ``--export_preds`` keeps
them: an accumulator fed from ``Trainer.eval_step`` outputs (tensors on any
device, or numpy), written as one npz keyed by sample id, the same keys and
rows as the JAX package writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class EvalArtifacts:
    """Accumulates per-batch eval outputs; only real graphs (mask 1) kept."""

    def __init__(self):
        self.sample_ids: List[int] = []
        self.preds: List[np.ndarray] = []
        self.preds_global: List[np.ndarray] = []
        self.ys: List[np.ndarray] = []
        self.embeddings: List[np.ndarray] = []

    def update(self, metrics: Dict, batch) -> None:
        keep = _host(batch.graph_mask) > 0.5
        self.sample_ids.extend(_host(batch.sample_id)[keep].tolist())
        self.preds.append(_host(metrics["preds"])[keep])
        self.preds_global.append(_host(metrics["preds_global"])[keep])
        self.ys.append(_host(metrics["y"])[keep])
        if "embeddings" in metrics:
            self.embeddings.append(_host(metrics["embeddings"])[keep])

    def result(self) -> Dict[str, np.ndarray]:
        out = {
            "sample_id": np.asarray(self.sample_ids, np.int64),
            "preds": np.concatenate(self.preds) if self.preds else np.zeros((0,)),
            "preds_global": (np.concatenate(self.preds_global)
                             if self.preds_global else np.zeros((0,))),
            "y": np.concatenate(self.ys) if self.ys else np.zeros((0,)),
        }
        if self.embeddings:
            out["embeddings"] = np.concatenate(self.embeddings)
        return out

    def save(self, path: str,
             mp_ids: Optional[Sequence[str]] = None) -> None:
        out = self.result()
        if mp_ids is not None:
            by_id = {i: m for i, m in enumerate(mp_ids)}
            out["mp_id"] = np.asarray(
                [by_id.get(int(s), str(s)) for s in out["sample_id"]])
        np.savez_compressed(path, **out)
