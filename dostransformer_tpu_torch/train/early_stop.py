"""Best-metric tracking and early stopping.

A copy of dostransformer_tpu/train/early_stop.py (which imports nothing of
jax, but its package does): the reference's three-branch best tracking and
plateau early stop (main_eDOS.py:133-175).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BestTracker:
    es: int = 50
    eval_every: int = 5
    best_rmse: float = 1000.0
    best_mae: float = 1000.0
    best_epoch: int = 0
    best_losses: list = dataclasses.field(default_factory=list)
    test_metrics: Optional[dict] = None

    def update(self, epoch: int, valid_rmse: float, valid_mae: float) -> bool:
        """Returns True if the test set should be (re-)evaluated now. The
        reference's three branches (main_eDOS.py:140-157), all with strict
        inequalities: (rmse<, mae<) updates both; (rmse<, mae>) rmse only;
        (rmse>, mae<) mae only. A tie in either metric updates nothing."""
        run_test = False
        if valid_rmse < self.best_rmse and valid_mae < self.best_mae:
            self.best_rmse, self.best_mae = valid_rmse, valid_mae
            self.best_epoch = epoch
            run_test = True
        elif valid_rmse < self.best_rmse and valid_mae > self.best_mae:
            self.best_rmse = valid_rmse
            self.best_epoch = epoch
            run_test = True
        elif valid_rmse > self.best_rmse and valid_mae < self.best_mae:
            self.best_mae = valid_mae
            self.best_epoch = epoch
            run_test = True
        return run_test

    def record_test(self, metrics: dict):
        self.test_metrics = dict(metrics)

    def step_and_should_stop(self) -> bool:
        """Append best_rmse and apply the plateau rule (main_eDOS.py:159-163)."""
        self.best_losses.append(self.best_rmse)
        if len(self.best_losses) > int(self.es / self.eval_every):
            if self.best_losses[-1] == self.best_losses[-int(self.es / 5)]:
                return True
        return False
