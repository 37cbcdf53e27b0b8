"""Best-metric tracking and early stopping.

A copy of dostransformer_tpu/train/early_stop.py (which imports nothing of
jax, but its package does): the reference's three-branch best tracking and
plateau early stop (main_eDOS.py:133-175), and the tracker as the plain
dict a checkpoint keeps (the fields of the JAX checkpoint's meta,
dostransformer_tpu/train/checkpoint.py).
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

    def to_dict(self) -> dict:
        """The tracker as plain Python values, the JAX checkpoint meta's
        ``tracker`` fields."""
        return {"es": self.es, "eval_every": self.eval_every,
                "best_rmse": self.best_rmse, "best_mae": self.best_mae,
                "best_epoch": self.best_epoch,
                "best_losses": list(map(float, self.best_losses)),
                "test_metrics": (dict(self.test_metrics)
                                 if self.test_metrics is not None else None)}

    @classmethod
    def from_dict(cls, d: dict) -> "BestTracker":
        return cls(es=d["es"], eval_every=d["eval_every"],
                   best_rmse=d["best_rmse"], best_mae=d["best_mae"],
                   best_epoch=d["best_epoch"],
                   best_losses=list(d["best_losses"]),
                   test_metrics=d.get("test_metrics"))
