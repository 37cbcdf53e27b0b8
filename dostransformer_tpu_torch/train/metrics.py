"""Evaluation metrics with reference semantics (utils.py:61-143).

Counterpart of dostransformer_tpu/train/metrics.py: per eval batch,
:func:`eval_metrics` gives each sample's metric contributions on the device
(eDOS clamps targets and predictions at 0; metrics score the system head
only); :class:`MetricAccumulator` takes the per-sample running means on the
host, with r2 variance-weighted over each flattened sample, exactly the
reference's batch-1 means at any eval batch size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dostransformer_tpu_torch.train.loss import clamp_negative


def r2_variance_weighted(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn r2_score(y.flatten(), p.flatten(), 'variance_weighted')
    (utils.py:20-23): on flattened single-output arrays,
    r2 = 1 - SS_res / SS_tot."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    ss_res = ((y_true - y_pred) ** 2).sum()
    ss_tot = ((y_true - y_true.mean()) ** 2).sum()
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return float(1.0 - ss_res / ss_tot)


def eval_metrics(preds_system: torch.Tensor, y: torch.Tensor,
                 clamp: bool = True,
                 graph_mask: Optional[torch.Tensor] = None) -> dict:
    """One eval batch's per-sample metric contributions, on the device.
    clamp=True: eDOS `test` semantics (utils.py:74-76); False: phDOS."""
    if clamp:
        y = clamp_negative(y)
        preds_system = clamp_negative(preds_system)
    mse = ((y - preds_system) ** 2).mean(-1)
    if graph_mask is None:
        graph_mask = torch.ones(y.shape[0], dtype=y.dtype, device=y.device)
    return {"mse": mse, "rmse": torch.sqrt(mse),
            "mae": (preds_system - y).abs().mean(-1), "mask": graph_mask,
            "preds": preds_system, "y": y}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class MetricAccumulator:
    """Per-sample running means over eval batches (utils.py:68-112),
    generalised to any batch size through the graph mask. ``update`` takes
    the tensors of :func:`eval_metrics` and copies them to the host."""

    def __init__(self):
        self.n = 0
        self.sums = {"rmse": 0.0, "mse": 0.0, "mae": 0.0, "r2": 0.0}

    def update(self, m: dict):
        mask = _host(m["mask"]) > 0.5
        n_real = int(mask.sum())
        if n_real == 0:
            return
        self.n += n_real
        for k in ("rmse", "mse", "mae"):
            self.sums[k] += float(_host(m[k])[mask].sum())
        ys = _host(m["y"])[mask]
        ps = _host(m["preds"])[mask]
        self.sums["r2"] += sum(r2_variance_weighted(yy, pp)
                               for yy, pp in zip(ys, ps))

    def result(self) -> dict:
        if self.n == 0:
            # zero samples must not read as a perfect eval (rmse 0.0 would
            # beat any real model in BestTracker)
            raise ValueError(
                "MetricAccumulator.result() with no real samples "
                "accumulated: the eval split is empty or all-dummy")
        return {k: v / self.n for k, v in self.sums.items()}
