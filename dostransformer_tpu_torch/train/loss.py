"""Training loss.

Counterpart of dostransformer_tpu/train/loss.py (reference
main_eDOS.py:111-123): eDOS targets are clamped at 0 from below in training
(predictions are not; they are at eval), per-sample MSE over the energy bins
-> sqrt -> mean over the real graphs of the batch, for both heads:
loss = rmse_global + beta * rmse_system. Dummy graphs (graph_mask 0) are
excluded from the mean.
"""

from __future__ import annotations

from typing import Optional

import torch


def clamp_negative(y: torch.Tensor) -> torch.Tensor:
    """torch.where(y < 0, 0, y) (main_eDOS.py:111-112)."""
    return torch.where(y < 0, 0.0, y)


def per_sample_rmse(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(mean_bins((y - pred)^2)) per sample -> [B].

    Safe-sqrt form: sqrt'(0) is infinite, and a row whose MSE is exactly 0
    (a dummy graph whose output hits its zero target) would turn the masked
    loss's 0 * inf into NaN in every gradient. The where-pair keeps the
    values (sqrt(mse) when mse > 0, 0 at 0) and makes the gradient 0 at 0."""
    mse = ((y - pred) ** 2).mean(-1)
    pos = mse > 0
    safe = torch.where(pos, mse, 1.0)
    return torch.where(pos, torch.sqrt(safe), 0.0)


def dos_loss_parts(preds_global: torch.Tensor,
                   preds_system: Optional[torch.Tensor], y: torch.Tensor,
                   graph_mask: torch.Tensor, clamp_targets: bool = True):
    """Unnormalised masked sums (sum_rmse_global, sum_rmse_system, count).
    preds_system=None (single-head models) returns sum_g for both heads."""
    if clamp_targets:
        y = clamp_negative(y)
    m = graph_mask.to(y.dtype)
    count = m.sum()
    sum_g = (per_sample_rmse(preds_global, y) * m).sum()
    if preds_system is None:
        return sum_g, sum_g, count
    sum_s = (per_sample_rmse(preds_system, y) * m).sum()
    return sum_g, sum_s, count


def dos_loss(preds_global: torch.Tensor, preds_system: Optional[torch.Tensor],
             y: torch.Tensor, graph_mask: torch.Tensor, beta: float = 1.0,
             clamp_targets: bool = True):
    """loss = mean_b rmse_global + beta * mean_b rmse_system over the real
    graphs; returns (loss, {"rmse_global", "rmse_system"})."""
    sum_g, sum_s, count = dos_loss_parts(preds_global, preds_system, y,
                                         graph_mask, clamp_targets)
    denom = torch.clamp(count, min=1.0)
    rmse_g = sum_g / denom
    rmse_s = sum_s / denom
    parts = {"rmse_global": rmse_g, "rmse_system": rmse_s}
    if preds_system is None:
        return rmse_g, parts
    return rmse_g + beta * rmse_s, parts
