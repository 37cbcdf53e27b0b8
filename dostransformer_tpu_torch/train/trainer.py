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
:meth:`Trainer.local_step` (as :meth:`Trainer.train_step` does). They return the per-step losses on the device,
for the caller to fetch once per chunk of epochs. :meth:`Trainer.eval_epoch`
scores a list of batches and stacks their metrics.

Under a profiler the epochs record their spans (tracing.py): ``train.epoch``
around an epoch, ``train.step`` around each step (its atom bucket an
attribute), and the step's phases ``step.input`` (the gather on the device,
or the host batch's upload), ``step.forward`` (``zero_grad``, the forward
and the loss), ``step.backward`` and ``step.optimizer`` (AdamW, with its
all-reduce under a mesh, to the step's end). Every epoch adds its counters:
``train.steps``, ``train.graphs`` and ``train.graph_slots`` (real graphs,
and every slot the dummies' included), ``train.atom_rows`` and
``train.atom_slots`` (the real graphs' node rows, and every slot's rows).

Data and tensor parallelism (``mesh``, a ``DeviceMesh`` from
parallel/mesh.py ``make_mesh`` over axes ("data",) or ("data", "model")),
the JAX package's shard_map step: every rank runs the kernels on its own
rows of the global batch (the 'data' rank d of n takes the contiguous rows
[d B/n, (d + 1) B/n); a device dataset holds only its rank's block of the
samples, see train/device_dataset.py). The global count of real graphs is
summed over 'data' first, each rank's loss is its rows' masked RMSE sums
over that count, and the flat gradient is summed over 'data' in the
optimizer (``AdamW.step(grad_group)``): the exact global batch mean
wherever the dummy graphs of a short batch fall (a DDP-style average over
ranks would not be). The losses are summed over 'data' for the caller.
Under a 'model' axis of more than one rank the model must be built with
``tp_axis="model"``, and the Trainer shards its FFNs over that axis
(nn/transformer.py ``shard_ffn_``) before any optimizer takes the
parameters; replicated parameters' gradients come out equal on every model
rank (tp_enter/tp_exit carry the FFN's collectives), so they too are
summed over 'data' only. A size-one axis still runs its collectives.

A bf16 model (``dtype="bfloat16"``) trains and evaluates on either device:
its parameters, their gradients and the optimizer state stay f32, the
activations are bf16, and on the card its backward runs the bf16 forms of
the message-passing and attention backward kernels (the plain versions on
the CPU). A step recomputes nothing in f32 that the forward ran in bf16.
An f64 model (``dtype="float64"``) runs its forward, its loss and its
backward in f64 (f64 outputs against f32 targets, as the JAX package's x64
runs do) through the plain functions; the gradients reach the f32
parameters in f32.

The dropout stream (the JAX package's ``TrainState.rng``): the Trainer
keeps one CPU generator seeded from ``seed``, the same on every rank. Each
train step draws one seed per 'data' rank from it, reseeds a generator on
the model's device with this rank's and hands it to the model's forward,
which draws its masks from it (a model with dropout, in training mode
only; eval and serving stay deterministic; a model without dropout takes
it and ignores it). So each 'data' rank
draws its own masks, as the JAX step folds in ``axis_index("data")``, and
the 'model' ranks of one data rank draw the same masks (their activations
are replicated; different masks would let the replicated parameters drift
apart). The CPU generator's state (:attr:`Trainer.dropout_rng`) goes into
checkpoints, so a resumed run draws what the uninterrupted one drew.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from dostransformer_tpu_torch import tracing
from dostransformer_tpu_torch.data.graph import GraphBatch
from dostransformer_tpu_torch.models.registry import model_outputs, system_dos
from dostransformer_tpu_torch.nn.transformer import (
    shard_ffn_,
    unsharded_ffns,
)
from dostransformer_tpu_torch.parallel.mesh import axis_info
from dostransformer_tpu_torch.train.loss import dos_loss
from dostransformer_tpu_torch.train.metrics import eval_metrics
from dostransformer_tpu_torch.train.optim import AdamW, make_adamw


class Trainer:
    """Owns one model and its optimizer; batches move to the model's
    device. ``mesh`` (optional) spreads the steps over processes (see the
    module docstring); a TP model whose FFNs are whole is sharded here, and
    then takes the default AdamW, built on the shards (an ``optimizer`` of
    a TP model is built after ``shard_ffn_``)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[AdamW] = None, beta: float = 1.0,
                 clamp_targets: bool = True, eval_clamp: bool = True,
                 mesh=None, seed: int = 0):
        self.mesh = mesh
        self.data_group, self.n_data, self.data_index = axis_info(mesh,
                                                                  "data")
        model_group, n_model, _ = axis_info(mesh, "model")
        if n_model > 1:
            if getattr(model, "tp_axis", None) != "model":
                # the FFN partial sums would silently never be reduced
                raise ValueError(
                    "a mesh with a 'model' axis requires the model to be "
                    "built with tp_axis='model' (Megatron FFN collectives); "
                    f"got tp_axis={getattr(model, 'tp_axis', None)!r} on "
                    f"{type(model).__name__}")
            if optimizer is not None and unsharded_ffns(model, "model"):
                raise ValueError("under a 'model' axis the FFNs are "
                                 "sharded before the optimizer takes the "
                                 "parameters: call nn.transformer.shard_ffn_"
                                 " first, or let the Trainer build the "
                                 "optimizer")
            shard_ffn_(model, "model", model_group)
        self.model = model
        self.optimizer = (optimizer if optimizer is not None
                          else make_adamw(model.parameters()))
        self.beta = beta
        self.clamp_targets = clamp_targets  # eDOS clamps train targets
        self.eval_clamp = eval_clamp        # eDOS `test` clamps, phDOS not
        self.device = next(model.parameters()).device
        # the dropout stream (see the module docstring)
        self.dropout_rng = torch.Generator().manual_seed(seed)
        self._step_rng = torch.Generator(self.device)

    def _dropout_generator(self) -> torch.Generator:
        """This step's dropout generator on the model's device, reseeded
        from the stream."""
        seeds = torch.randint(0, 2 ** 62, (self.n_data,),
                              generator=self.dropout_rng)
        return self._step_rng.manual_seed(int(seeds[self.data_index]))

    def _check_batch(self, batch_size: int) -> None:
        """A global batch must split evenly over the 'data' ranks."""
        if batch_size % self.n_data:
            raise ValueError(
                f"batch size {batch_size} must be divisible by the "
                f"{self.n_data}-rank 'data' mesh axis (each rank takes "
                f"batch/{self.n_data} samples; choose --batch_size a "
                f"multiple of {self.n_data})")

    def _local_rows(self, batch: GraphBatch) -> GraphBatch:
        """This 'data' rank's rows of a global batch."""
        self._check_batch(batch.num_graphs)
        if self.n_data == 1:
            return batch
        step = batch.num_graphs // self.n_data
        return batch.rows(self.data_index * step,
                          (self.data_index + 1) * step)

    def train_step(self, batch: GraphBatch) -> dict:
        """One optimizer step on a global batch (this rank runs its rows).
        After it each parameter's ``.grad`` holds this rank's share of the
        step's gradient. Returns 0-d device tensors {"loss",
        "rmse_global", "rmse_system"} of the global batch; a single-head
        model is scored on its one DOS, which both RMSEs then report."""
        return self.local_step(self._local_rows(batch))

    def local_step(self, batch: GraphBatch) -> dict:
        """One optimizer step on this rank's rows ``batch`` (the whole
        batch without a mesh); what :meth:`train_step` and the device
        dataset's epochs run."""
        tracing.phase("step.forward")
        batch = batch.to(self.device)
        self.model.train()
        self.optimizer.zero_grad()
        count = None
        if self.data_group is not None:
            count = batch.graph_mask.to(torch.float32).sum()
            dist.all_reduce(count, group=self.data_group)
        dos_global, _, dos_system = model_outputs(
            self.model(batch, generator=self._dropout_generator()))
        loss, parts = dos_loss(dos_global, dos_system, batch.y,
                               batch.graph_mask, self.beta,
                               self.clamp_targets, count=count)
        tracing.phase("step.backward")
        loss.backward()
        tracing.phase("step.optimizer")
        self.optimizer.step(grad_group=self.data_group)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in parts.items()}}
        if self.data_group is not None:
            total = torch.stack(list(out.values()))
            dist.all_reduce(total, group=self.data_group)
            out = dict(zip(out, total.unbind()))
        return out

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> dict:
        """Per-sample metrics of the system head (device tensors; a
        single-head model's of its one DOS), the global head's predictions,
        and where the model returns node embeddings the graph embeddings
        (their masked sum-pool), for this rank's rows of the global batch
        (parallel/mesh.py ``fetch_global`` joins the ranks' rows)."""
        batch = self._local_rows(batch).to(self.device)
        self.model.eval()
        out = self.model(batch)
        dos_global, x, _ = model_outputs(out)
        m = eval_metrics(system_dos(out), batch.y, clamp=self.eval_clamp,
                         graph_mask=batch.graph_mask)
        if x is not None:
            m["embeddings"] = (x * batch.node_mask[..., None]).sum(1)
        m["preds_global"] = dos_global
        return m

    def train_epoch(self, loader: Iterable[GraphBatch],
                    epoch: int = 0) -> torch.Tensor:
        """One pass over a host loader (of batches on the host), epoch
        ``epoch`` of the run; the per-step losses [S] come back to the host
        once, at the end."""
        losses, counts = [], Counter()
        with tracing.span("train.epoch", device=self.device, epoch=epoch):
            for i, batch in enumerate(loader):
                rows = self._local_rows(batch)
                counts.update({
                    "train.steps": 1,
                    "train.graphs": int(rows.graph_mask.sum()),
                    "train.graph_slots": rows.num_graphs,
                    "train.atom_rows": int(rows.node_mask.sum()),
                    "train.atom_slots": (rows.num_graphs
                                         * rows.atoms_per_graph)})
                with tracing.span("train.step", step=(epoch, i),
                                  bucket=rows.atoms_per_graph):
                    tracing.phase("step.input")
                    rows = rows.to(self.device)
                    losses.append(self.local_step(rows)["loss"])
            for name, n in counts.items():
                tracing.count(name, n)
        return torch.stack(losses).cpu()

    def _device_epoch(self, dataset, perm, epoch: int, first: int = 0
                      ) -> list:
        """Train steps over ``dataset`` (a DeviceDataset: under a mesh this
        rank's block) in the order ``perm`` [S, local B] (indices into the
        block; any device; uploaded once), the steps ``first`` on of epoch
        ``epoch``; the step losses."""
        self._check_batch(dataset.batch_size)
        perm = torch.as_tensor(perm)
        want = (dataset.steps_per_epoch, dataset.local_batch)
        if tuple(perm.shape) != want:
            raise ValueError(f"perm is {tuple(perm.shape)}, this dataset "
                             f"takes {want}")
        perm = perm.to(dataset.device, torch.int64)
        for name, n in dataset.epoch_counts().items():
            tracing.count(name, n)
        bucket = dataset.data.atoms_per_graph
        losses = []
        for i, idx in enumerate(perm, first):
            with tracing.span("train.step", step=(epoch, i), bucket=bucket):
                tracing.phase("step.input")
                batch = dataset.batch(idx)
                losses.append(self.local_step(batch)["loss"])
        return losses

    def train_epoch_device(self, dataset, seed: int = 0, epoch: int = 0,
                           perm=None) -> torch.Tensor:
        """One epoch over a DeviceDataset in the order of ``perm`` [S, B]
        (default: the dataset's :func:`epoch_perm` of (seed, epoch)).
        Returns the step losses [S] on the device."""
        if perm is None:
            perm = dataset.perm(seed, epoch)
        with tracing.span("train.epoch", device=self.device, epoch=epoch):
            return torch.stack(self._device_epoch(dataset, perm, epoch))

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
        with tracing.span("train.epoch", device=self.device, epoch=epoch):
            for i, (_, dds) in enumerate(bucketed.buckets):
                perm = dds.perm(seed, epoch, i) if perms is None else perms[i]
                losses += self._device_epoch(dds, perm, epoch, len(losses))
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
