"""Training and evaluation steps on one device.

Counterpart of the single-device path of dostransformer_tpu/train/trainer.py
`Trainer`: one train step is the forward, :func:`dos_loss`, the backward and
the AdamW step (:mod:`train.optim`); one eval step scores the system head
with :func:`eval_metrics`. On the card the forward and backward run through
the fused message-passing and attention kernels, forward and backward.

PyTorch runs eagerly, so there is no jit, scan or buffer donation; a step
returns 0-d device tensors and never waits for the card, and
:meth:`Trainer.train_epoch` fetches an epoch's losses once at its end. Data
and tensor parallelism are ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.train.loss import dos_loss
from dostransformer_tpu_torch.train.metrics import eval_metrics
from dostransformer_tpu_torch.train.optim import AdamW, make_adamw


class Trainer:
    """Owns one model and its optimizer; batches move to the model's
    device."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[AdamW] = None, beta: float = 1.0,
                 clamp_targets: bool = True, eval_clamp: bool = True):
        self.model = model
        self.optimizer = (optimizer if optimizer is not None
                          else make_adamw(model.parameters()))
        self.beta = beta
        self.clamp_targets = clamp_targets  # eDOS clamps train targets
        self.eval_clamp = eval_clamp        # eDOS `test` clamps, phDOS not
        self.device = next(model.parameters()).device

    def train_step(self, batch: GraphBatch) -> dict:
        """One optimizer step. After it each parameter's ``.grad`` holds
        this step's gradient. Returns 0-d device tensors {"loss",
        "rmse_global", "rmse_system"}."""
        batch = batch.to(self.device)
        self.model.train()
        self.optimizer.zero_grad()
        dos_global, _, dos_system = self.model(batch)
        loss, parts = dos_loss(dos_global, dos_system, batch.y,
                               batch.graph_mask, self.beta,
                               self.clamp_targets)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in parts.items()}}

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> dict:
        """Per-sample metrics of the system head (device tensors), plus
        the graph embeddings (masked sum-pool of the node embeddings) and
        the global head's predictions."""
        batch = batch.to(self.device)
        self.model.eval()
        dos_global, x, dos_system = self.model(batch)
        m = eval_metrics(dos_system, batch.y, clamp=self.eval_clamp,
                         graph_mask=batch.graph_mask)
        m["embeddings"] = (x * batch.node_mask[..., None]).sum(1)
        m["preds_global"] = dos_global
        return m

    def train_epoch(self, loader: Iterable[GraphBatch]) -> torch.Tensor:
        """One pass over a host loader; the per-step losses [S] come back to
        the host once, at the end."""
        losses = [self.train_step(batch)["loss"] for batch in loader]
        return torch.stack(losses).cpu()
