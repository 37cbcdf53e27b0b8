"""The kind of traffic a mix file can ask for, driving the port's own
entry point: ``train`` (``Trainer.train_epochs_buckets`` over a corpus on
the card as a ``BucketedDeviceDataset``, the path of ``main_edos
--bucketed``). A new kind is a new class in :data:`DRIVERS`.

A driver's life: :meth:`setup` (inputs and weights from the seed, the
program built and warmed on every shape its traffic uses), then either
:meth:`window` (measured for a number of seconds) or :meth:`span` (a few
whole units under the profiler), then :meth:`finish` (the program's state
freed) and :meth:`checks`, which runs the plain reference and returns the
numbers that decide ``correct``. Everything is made from the seed: the
same seed gives the same inputs and weights.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import reference, synth
from perfbench.trace import SPAN, Span


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap between two norms: |prog - ref| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _build_model(cfg: dict, example, device):
    from dostransformer_tpu_torch.models.registry import build_model

    widths = {"node_in": example.x.shape[1]}
    if example.edge_attr is not None:
        widths["edge_in"] = example.edge_attr.shape[1]
    if example.glob is not None:
        widths["glob_in"] = example.glob.shape[-1]
    if "r_max" in cfg:
        widths["r_max"] = cfg["r_max"]
    return build_model(cfg["task"], "DOSTransformer", layers=cfg["layers"],
                       t_layers=cfg["t_layers"], hidden=cfg["hidden"],
                       n_bins=cfg["bins"], padding=cfg["padding"],
                       dtype=cfg["dtype"],
                       device=device,
                       generator=torch.Generator().manual_seed(0), **widths)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TrainDriver:
    """``train``: a corpus of ``crystals`` crystals on the card, bucketed,
    at ``batch_size``; the window trains whole epochs."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        if cfg["task"] != mix["task"]:
            raise ValueError(f"traffic for {mix['task']} on a "
                             f"{cfg['task']} configuration")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.attempted = self.failed = 0

    def _model(self, example):
        from dostransformer_tpu_torch.models.import_torch import (
            load_reference_state_dict,
        )

        self.state = reference.make_state_dict(self.cfg, self.seed,
                                               self.device)
        model = _build_model(self.cfg, example, self.device)
        load_reference_state_dict(model, self.state)
        return model

    def _profiled(self, fn) -> Span:
        from torch.profiler import ProfilerActivity, profile, record_function

        from perfbench.trace import read_profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(SPAN):
                span = fn()
                _sync(self.device)
        return read_profile(prof, span, on_cpu=self.device.type == "cpu")


    def setup(self) -> None:
        from dostransformer_tpu_torch.data.graph import bucket_size
        from dostransformer_tpu_torch.train.device_dataset import (
            BucketedDeviceDataset,
        )
        from dostransformer_tpu_torch.train.trainer import Trainer

        cfg, mix, bs = self.cfg, self.mix, self.mix["batch_size"]
        self.corpus = synth.crystals(cfg["task"], mix, mix["crystals"],
                                     self.rng, cfg["bins"])
        self.model = self._model(self.corpus[0])
        self.trainer = Trainer(self.model, beta=cfg["beta"],
                               clamp_targets=cfg["task"] == "edos",
                               eval_clamp=cfg["task"] == "edos",
                               seed=self.seed)
        self.data = BucketedDeviceDataset.from_samples(self.corpus, bs,
                                                       device=self.device)
        # the first steps, through the window's call and feed, each on one
        # batch of distinct crystals of one atom bucket (grouped by the
        # port's own rule), ``check`` giving [bucket index, crystals]: a
        # batch of fewer than batch_size crystals is padded with dummy
        # graphs, as every bucket of the window's corpus is
        by_bucket: Dict[int, List[int]] = {}
        for i, s in enumerate(self.corpus):
            by_bucket.setdefault(bucket_size(s.n_nodes), []).append(i)
        buckets = sorted(by_bucket)
        self.check_batches = [
            [self.corpus[i] for i in
             self.rng.choice(by_bucket[buckets[k]], n, replace=False)]
            for k, n in mix["check"]]
        params = dict(self.model.named_parameters())
        self.prog_losses: List[float] = []
        for step, batch in enumerate(self.check_batches):
            one = BucketedDeviceDataset.from_samples(batch, bs,
                                                     device=self.device)
            if one.steps_per_epoch != 1:
                raise ValueError("a check batch spans more than one step")
            losses = self.trainer.train_epochs_buckets(one, self.seed, [0])
            self.prog_losses.append(float(losses.reshape(-1)[0]))
            if step == 0:  # the gradient as AdamW took it: nu = (1-b2) g^2
                self.prog_grad = {
                    k: float(torch.sqrt(
                        self.trainer.optimizer.moments(p)[1].double().sum()
                        / (1 - reference.B2)))
                    for k, p in params.items()}
        self.prog_change = {k: float((p.detach() - self.state[k]).double()
                                     .norm()) for k, p in params.items()}
        self.trainer.train_epochs_buckets(self.data, self.seed, [0]).cpu()
        self.epoch = 1
        self.real = len(self.corpus)
        self.steps = self.data.steps_per_epoch

    def _epoch(self) -> None:
        losses = self.trainer.train_epochs_buckets(self.data, self.seed,
                                                   [self.epoch]).cpu()
        self.epoch += 1
        self.attempted += losses.numel()
        self.failed += int((~torch.isfinite(losses)).sum())

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        epochs = 0
        while True:
            self._epoch()
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        print(f"window: {epochs} epochs of {self.steps} steps in "
              f"{elapsed:.3f} s", flush=True)
        return {"train_crystals_per_s": epochs * self.real / elapsed}

    def span(self) -> Span:
        epochs = self.mix["trace_epochs"]

        def run():
            for _ in range(epochs):
                self._epoch()
            return Span("train", self.cfg,
                        [(s.n_nodes, s.n_edges) for s in self.corpus] * epochs,
                        epochs * self.steps)

        return self._profiled(run)

    def finish(self) -> None:
        del self.trainer, self.model, self.data
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, tf32: bool = False, half: bool = False):
        """(losses, first-step gradient norms, change norms after the
        steps) of the reference from the same weights on the same batches
        (with ``half``, on the first half of each: a planted fault)."""
        chunks = [reference.Chunk(b[:len(b) // 2] if half else b,
                                  self.cfg["task"], self.device)
                  for b in self.check_batches]
        losses, grads, after = reference.train_steps(
            self.state, self.cfg, chunks, self.cfg["beta"], tf32)
        grad = {k: float(g.double().norm()) for k, g in grads.items()}
        change = {k: float((after[k] - self.state[k]).double().norm())
                  for k in after}
        return losses, grad, change

    def checks(self, prog=None) -> Dict[str, float]:
        """The compared numbers of the program (or of ``prog``, readings
        in the program's place) against the f32 reference: the worst
        step's relative loss gap, the first gradient's worst leaf gap, and
        the median leaf's gap of the change after the steps (the worst
        leaf's swings with round-off that AdamW's normalised update
        magnifies, in the f32 reference as much as in the program). Leaves
        whose reference gradient is under a thousandth of the median
        leaf's move by round-off alone and are left out of the change."""
        ref_loss, ref_grad, ref_change = self.readings()
        if prog is None:
            prog = (self.prog_losses, self.prog_grad, self.prog_change)
        p_loss, p_grad, p_change = prog
        med = statistics.median(ref_grad.values())
        moving = [k for k, g in ref_grad.items() if g >= 1e-3 * med]
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(p_loss, ref_loss)),
            "grad_gap": max(leaf_gaps(p_grad, ref_grad)),
            "change_gap_median": statistics.median(
                leaf_gaps(p_change, ref_change, moving)),
        }

    def control(self) -> Dict[str, float]:
        """The checks with the reference in TF32 in the program's place."""
        return self.checks(prog=self.readings(tf32=True))

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The checks of the faults a training step can have, planted in
        the reference put in the program's place: half of each batch left
        out (the mean over the rest), and a step that leaves the state
        unchanged (every loss at the first weights; AdamW's state and the
        change stay 0, so the gradient and the change read 1)."""
        chunks = [reference.Chunk(b, self.cfg["task"], self.device)
                  for b in self.check_batches]
        with torch.no_grad():
            frozen = [float(reference.loss(self.state, self.cfg, c,
                                           self.cfg["beta"]))
                      for c in chunks]
        zero = {k: 0.0 for k in self.state}
        return {"half_batch": self.checks(prog=self.readings(half=True)),
                "state_unchanged": self.checks(prog=(frozen, zero, zero))}


DRIVERS = {"train": TrainDriver}
