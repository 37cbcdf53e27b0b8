"""Training and evaluation steps on one device.

Counterpart of the single-device path of dostransformer_tpu/train/trainer.py
`Trainer`: one train step is the forward, :func:`dos_loss`, the backward and
the AdamW step (:mod:`train.optim`); one eval step scores the system head
with :func:`eval_metrics`. On the card the forward and backward run through
the fused message-passing and attention kernels, forward and backward.

A step returns 0-d device tensors and never waits for the card. The epoch
methods take their batches from a host loader (:meth:`Trainer.train_epoch`)
or from a dataset resident on the device (train/device_dataset.py:
:meth:`Trainer.train_epoch_device`, :meth:`Trainer.train_epochs_device`,
:meth:`Trainer.train_epoch_buckets`, :meth:`Trainer.train_epochs_buckets`),
where each step gathers its batch on the device by a row of the epoch's
index tensor [S, B], uploaded once an epoch without a host wait. They
return the per-step losses on the device, for the caller to fetch once per
chunk of epochs. :meth:`Trainer.eval_epoch` scores a list of batches and
stacks their metrics.

The device dataset's steps replay CUDA graphs where :attr:`Trainer.replays`
holds (one card, no mesh, a model that does not compute in f64, this
package's AdamW, and ``graphs`` left on): each batch geometry (atom bucket,
edges, batch) gets three graphs, captured at its first step after one eager
forward and backward on a side stream whose gradients are dropped (no
optimizer step; the dropout stream untouched): the forward with
``zero_grad`` and the loss, the backward into the flat gradient buffer, and
AdamW on the flat buffers (train/optim.py), the three of a geometry in one
memory pool. Every step of that geometry, its first included, gathers its
rows into the graphs' static inputs (``index_select`` into them), copies
its row of the epoch's AdamW scalars (:meth:`AdamW.scalar_table`, uploaded
with the order) into a static scalar, reseeds the step's dropout generator
from the stream (the generator is registered with the forward's graph, so a
replay draws the eager step's masks) and replays the three; its loss is
copied out before the next replay. A capture that fails raises: nothing
falls back to the eager step. Every other step (the host loader's, a mesh's,
the CPU's, an f64 model's, or with ``graphs=False``, the replays' oracle)
runs :meth:`Trainer.local_step` eagerly; replayed and eager steps give the
same bits on the card.

Under a profiler the epochs record their spans (tracing.py): ``train.epoch``
around an epoch, ``train.step`` around each step (its atom bucket an
attribute), and the step's phases ``step.input`` (the gather on the device,
or the host batch's upload; under replay also the scalars' row, and a
geometry's capture at its first step), ``step.forward`` (``zero_grad``, the
forward and the loss), ``step.backward`` and ``step.optimizer`` (AdamW,
with its all-reduce under a mesh, to the step's end); under replay each of
the last three is its graph's replay. Every epoch adds its counters:
``train.steps``, ``train.graphs`` and ``train.graph_slots`` (real graphs,
and every slot the dummies' included), ``train.atom_rows`` and
``train.atom_slots`` (the real graphs' node rows, and every slot's rows),
``train.steps_replayed`` (the steps that replayed graphs, 0 in an epoch of
eager steps); each capture adds one to ``train.captures``.

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

import dataclasses
from collections import Counter
from typing import Dict, Iterable, Optional, Sequence

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


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor bound for the card goes through
    pinned memory, copied on the stream without a host wait."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _StepGraphs:
    """One batch geometry's captured train step: the static inputs the
    step's rows are gathered into, its three CUDA graphs (forward with the
    loss, backward, AdamW) in one memory pool, and the static loss (None
    until captured)."""

    def __init__(self, data: GraphBatch, batch: int):
        self.inputs = _static_inputs(data, batch)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        self.loss = None


def _static_inputs(data: GraphBatch, batch: int) -> GraphBatch:
    """Uninitialised tensors of ``batch`` graphs of ``data``'s fields, on
    its device in its dtypes."""
    return dataclasses.replace(data, **{
        f.name: t.new_empty((batch,) + tuple(t.shape[1:]))
        for f in dataclasses.fields(data)
        if (t := getattr(data, f.name)) is not None})


def _geometry(dataset) -> tuple:
    """A DeviceDataset's batch geometry: local batch, then each field's
    name, per-graph shape and dtype."""
    data = dataset.data
    return (dataset.local_batch,) + tuple(
        (f.name, tuple(t.shape[1:]), t.dtype)
        for f in dataclasses.fields(data)
        if (t := getattr(data, f.name)) is not None)


class Trainer:
    """Owns one model and its optimizer; batches move to the model's
    device. ``mesh`` (optional) spreads the steps over processes (see the
    module docstring); a TP model whose FFNs are whole is sharded here, and
    then takes the default AdamW, built on the shards (an ``optimizer`` of
    a TP model is built after ``shard_ffn_``). ``graphs=False`` keeps every
    step eager (:attr:`replays`)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[AdamW] = None, beta: float = 1.0,
                 clamp_targets: bool = True, eval_clamp: bool = True,
                 mesh=None, seed: int = 0, graphs: bool = True):
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
        self.graphs = graphs
        self._captured: Dict[tuple, _StepGraphs] = {}
        self._scalars = None  # the replayed AdamW's scalars, on the card
        self._side = None     # the warm-ups' stream

    @property
    def replays(self) -> bool:
        """Whether the device dataset's steps replay CUDA graphs: on a
        card without a mesh, for a model that does not compute in f64, with
        this package's AdamW, unless ``graphs`` is off."""
        return (self.graphs and self.mesh is None
                and self.device.type == "cuda"
                and getattr(self.model, "cdtype", None) != torch.float64
                and type(self.optimizer) is AdamW)

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
        loss, parts = self._loss(batch, self._dropout_generator(), count)
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

    def _loss(self, batch: GraphBatch, generator: torch.Generator,
              count=None):
        """The forward and :func:`dos_loss` of one batch: (loss, parts)."""
        dos_global, _, dos_system = model_outputs(
            self.model(batch, generator=generator))
        return dos_loss(dos_global, dos_system, batch.y, batch.graph_mask,
                        self.beta, self.clamp_targets, count=count)

    def _capture(self, entry: _StepGraphs) -> None:
        """Capture a geometry's step from its static inputs, which hold
        the step's rows: first a forward and backward on a side stream
        whose gradients the captured ``zero_grad`` drops (no optimizer
        step, the dropout stream untouched), then the three graphs."""
        opt, batch = self.optimizer, entry.inputs
        stream = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._scalars = torch.zeros(3, device=self.device)
        self._side.wait_stream(stream)
        with torch.cuda.stream(self._side):
            opt.zero_grad()
            self._loss(batch, self._step_rng.manual_seed(0))[0].backward()
        stream.wait_stream(self._side)
        forward, backward, update = entry.graphs
        forward.register_generator_state(self._step_rng)
        try:
            with torch.cuda.graph(forward, pool=entry.pool,
                                  capture_error_mode="thread_local"):
                opt.zero_grad()
                loss = self._loss(batch, self._step_rng)[0]
            with torch.cuda.graph(backward, pool=entry.pool,
                                  capture_error_mode="thread_local"):
                loss.backward()
            with torch.cuda.graph(update, pool=entry.pool,
                                  capture_error_mode="thread_local"):
                opt.captured_step(self._scalars)
        except Exception as e:
            shapes = {f.name: tuple(t.shape) for f in dataclasses.fields(batch)
                      if (t := getattr(batch, f.name)) is not None}
            raise RuntimeError(f"CUDA graph capture of the train step failed "
                               f"at inputs {shapes}: {e}") from e
        entry.loss = loss.detach()  # the autograd graph goes with ``loss``
        tracing.count("train.captures", 1)

    def _replayed_epoch(self, dataset, perm: torch.Tensor, epoch: int,
                        first: int) -> torch.Tensor:
        """The steps of :meth:`_device_epoch` as replays of the dataset's
        geometry's graphs (see the module docstring); the step losses."""
        steps = perm.shape[0]
        self.optimizer.check_views()
        table = _to_device(self.optimizer.scalar_table(steps),
                           dataset.device)
        key = _geometry(dataset)
        entry = self._captured.get(key)
        if entry is None:
            entry = _StepGraphs(dataset.data, dataset.local_batch)
        fields = [(t, getattr(entry.inputs, f.name))
                  for f in dataclasses.fields(dataset.data)
                  if (t := getattr(dataset.data, f.name)) is not None]
        forward, backward, update = entry.graphs
        self.model.train()
        out = None
        bucket = dataset.data.atoms_per_graph
        for i in range(steps):
            with tracing.span("train.step", step=(epoch, first + i),
                              bucket=bucket):
                tracing.phase("step.input")
                for src, dst in fields:
                    torch.index_select(src, 0, perm[i], out=dst)
                if entry.loss is None:
                    self._capture(entry)
                    self._captured[key] = entry
                if out is None:
                    out = torch.empty(steps, dtype=entry.loss.dtype,
                                      device=dataset.device)
                self._scalars.copy_(table[i])
                self._dropout_generator()
                tracing.phase("step.forward")
                forward.replay()
                tracing.phase("step.backward")
                backward.replay()
                tracing.phase("step.optimizer")
                update.replay()
                self.optimizer.advance()
                out[i].copy_(entry.loss)
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
            counts["train.steps_replayed"] = 0
            for name, n in counts.items():
                tracing.count(name, n)
        return torch.stack(losses).cpu()

    def _device_epoch(self, dataset, perm, epoch: int, first: int = 0
                      ) -> torch.Tensor:
        """Train steps over ``dataset`` (a DeviceDataset: under a mesh this
        rank's block) in the order ``perm`` [S, local B] (indices into the
        block; any device; uploaded once), the steps ``first`` on of epoch
        ``epoch``, replayed where :attr:`replays` holds; the step losses
        [S]."""
        self._check_batch(dataset.batch_size)
        perm = torch.as_tensor(perm)
        want = (dataset.steps_per_epoch, dataset.local_batch)
        if tuple(perm.shape) != want:
            raise ValueError(f"perm is {tuple(perm.shape)}, this dataset "
                             f"takes {want}")
        perm = _to_device(perm.to(torch.int64), dataset.device)
        for name, n in dataset.epoch_counts().items():
            tracing.count(name, n)
        replays = self.replays
        tracing.count("train.steps_replayed", len(perm) if replays else 0)
        if replays:
            return self._replayed_epoch(dataset, perm, epoch, first)
        bucket = dataset.data.atoms_per_graph
        losses = []
        for i, idx in enumerate(perm, first):
            with tracing.span("train.step", step=(epoch, i), bucket=bucket):
                tracing.phase("step.input")
                batch = dataset.batch(idx)
                losses.append(self.local_step(batch)["loss"])
        return torch.stack(losses)

    def train_epoch_device(self, dataset, seed: int = 0, epoch: int = 0,
                           perm=None) -> torch.Tensor:
        """One epoch over a DeviceDataset in the order of ``perm`` [S, B]
        (default: the dataset's :func:`epoch_perm` of (seed, epoch)).
        Returns the step losses [S] on the device."""
        if perm is None:
            perm = dataset.perm(seed, epoch)
        with tracing.span("train.epoch", device=self.device, epoch=epoch):
            return self._device_epoch(dataset, perm, epoch)

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
        losses, done = [], 0
        with tracing.span("train.epoch", device=self.device, epoch=epoch):
            for i, (_, dds) in enumerate(bucketed.buckets):
                perm = dds.perm(seed, epoch, i) if perms is None else perms[i]
                losses.append(self._device_epoch(dds, perm, epoch, done))
                done += dds.steps_per_epoch
            return torch.cat(losses)

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
