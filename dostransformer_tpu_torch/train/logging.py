"""Metrics logging: structured JSONL and the reference's append-only
``experiments_{embedder}.txt`` block (main_eDOS.py:91,167-186).

A copy of dostransformer_tpu/train/logging.py, so the port writes the same
bytes without importing the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JSONLLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, record: dict):
        if self._f is None:
            return
        record = {"time": time.time(), **record}
        self._f.write(json.dumps(record, default=float) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()


def write_experiment_result(
    path: str,
    configuration: str,
    best_epoch: int,
    test_rmse: float,
    test_mse: float,
    test_mae: float,
    test_r2: float,
    early_stopped: bool = False,
):
    """Append a result block in the reference's exact format
    (main_eDOS.py:167-186)."""
    with open(path, "a") as f:
        f.write("\n")
        if early_stopped:
            f.write("Early stop!!\n")
        f.write(configuration)
        f.write("\nbest epoch : {} \n".format(best_epoch))
        f.write("best RMSE : {:.4f} \n".format(test_rmse))
        f.write("best MSE : {:.4f} \n".format(test_mse))
        f.write("best MAE : {:.4f} \n".format(test_mae))
        f.write("best R2 : {:.4f} \n".format(test_r2))
