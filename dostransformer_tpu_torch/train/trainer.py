"""Training and evaluation steps on one device.

Counterpart of the single-device path of dostransformer_tpu/train/trainer.py
`Trainer`: one train step is the forward, :func:`dos_loss`, the backward and
the AdamW step (:mod:`train.optim`); one eval step scores the system head
with :func:`eval_metrics`. On the card the forward and backward run through
the fused message-passing and attention kernels, forward and backward.

PyTorch runs eagerly, so there is no jit, scan or buffer donation; a step
returns 0-d device tensors and never waits for the card. The epoch methods
take their batches from a host loader (:meth:`Trainer.train_epoch`) or from
a dataset resident on the device (train/device_dataset.py:
:meth:`Trainer.train_epoch_device`, :meth:`Trainer.train_epochs_device`,
:meth:`Trainer.train_epoch_buckets`, :meth:`Trainer.train_epochs_buckets`),
where each step gathers its batch on the device by a row of the epoch's
index tensor [S, B], uploaded once an epoch; every step goes through
:meth:`Trainer.train_step`. They return the per-step losses on the device,
for the caller to fetch once per chunk of epochs. :meth:`Trainer.eval_epoch`
scores a list of batches and stacks their metrics. Data and tensor
parallelism are ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.models.registry import model_outputs, system_dos
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
        "rmse_global", "rmse_system"}; a single-head model is scored on its
        one DOS, which both RMSEs then report."""
        batch = batch.to(self.device)
        self.model.train()
        self.optimizer.zero_grad()
        dos_global, _, dos_system = model_outputs(self.model(batch))
        loss, parts = dos_loss(dos_global, dos_system, batch.y,
                               batch.graph_mask, self.beta,
                               self.clamp_targets)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in parts.items()}}

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> dict:
        """Per-sample metrics of the system head (device tensors; a
        single-head model's of its one DOS), the global head's predictions,
        and where the model returns node embeddings the graph embeddings
        (their masked sum-pool)."""
        batch = batch.to(self.device)
        self.model.eval()
        out = self.model(batch)
        dos_global, x, _ = model_outputs(out)
        m = eval_metrics(system_dos(out), batch.y, clamp=self.eval_clamp,
                         graph_mask=batch.graph_mask)
        if x is not None:
            m["embeddings"] = (x * batch.node_mask[..., None]).sum(1)
        m["preds_global"] = dos_global
        return m

    def train_epoch(self, loader: Iterable[GraphBatch]) -> torch.Tensor:
        """One pass over a host loader; the per-step losses [S] come back to
        the host once, at the end."""
        losses = [self.train_step(batch)["loss"] for batch in loader]
        return torch.stack(losses).cpu()

    def _device_epoch(self, dataset, perm) -> list:
        """Train steps over ``dataset`` (a DeviceDataset) in the order
        ``perm`` [S, B] (any device; uploaded once); the step losses."""
        perm = torch.as_tensor(perm)
        want = (dataset.steps_per_epoch, dataset.batch_size)
        if tuple(perm.shape) != want:
            raise ValueError(f"perm is {tuple(perm.shape)}, this dataset "
                             f"takes {want}")
        perm = perm.to(dataset.device, torch.int64)
        return [self.train_step(dataset.batch(idx))["loss"] for idx in perm]

    def train_epoch_device(self, dataset, seed: int = 0, epoch: int = 0,
                           perm=None) -> torch.Tensor:
        """One epoch over a DeviceDataset in the order of ``perm`` [S, B]
        (default: the dataset's :func:`epoch_perm` of (seed, epoch)).
        Returns the step losses [S] on the device."""
        if perm is None:
            perm = dataset.perm(seed, epoch)
        return torch.stack(self._device_epoch(dataset, perm))

    def train_epochs_device(self, dataset, seed: int, epochs: Sequence[int],
                            perms=None) -> torch.Tensor:
        """The epochs ``epochs`` (each 0 for the first of a run) over a
        DeviceDataset, each in its own (seed, epoch) order or in
        ``perms[i]``; the same order as as many calls of
        :meth:`train_epoch_device`. Returns the losses [E, S] on the
        device."""
        return torch.stack([
            self.train_epoch_device(dataset, seed, e,
                                    None if perms is None else perms[i])
            for i, e in enumerate(epochs)])

    def train_epoch_buckets(self, bucketed, seed: int = 0, epoch: int = 0,
                            perms=None) -> torch.Tensor:
        """One epoch over a BucketedDeviceDataset, bucket after bucket
        (ascending), each in its own (seed, epoch, bucket) order or in
        ``perms[i]``. Returns the step losses [S] on the device, in bucket
        order."""
        losses = []
        for i, (_, dds) in enumerate(bucketed.buckets):
            perm = dds.perm(seed, epoch, i) if perms is None else perms[i]
            losses += self._device_epoch(dds, perm)
        return torch.stack(losses)

    def train_epochs_buckets(self, bucketed, seed: int, epochs: Sequence[int],
                             perms=None) -> torch.Tensor:
        """:meth:`train_epoch_buckets` for each of ``epochs`` (epochs
        outer, buckets inner); ``perms[i]`` the i-th epoch's per-bucket
        orders. Returns the losses [E, S] on the device."""
        return torch.stack([
            self.train_epoch_buckets(bucketed, seed, e,
                                     None if perms is None else perms[i])
            for i, e in enumerate(epochs)])

    def eval_epoch(self, batches: Sequence[GraphBatch]) -> dict:
        """:meth:`eval_step` on each batch (all of one shape); its outputs
        stacked, each [S, ...] on the device: index them per batch and feed
        MetricAccumulator or EvalArtifacts as eval_step's."""
        ms = [self.eval_step(b) for b in batches]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
