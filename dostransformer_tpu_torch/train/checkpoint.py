"""Training checkpoints: weights, optimizer state, epoch and best tracker.

Counterpart of dostransformer_tpu/train/checkpoint.py (orbax there, torch
files here). The reference never saves its model; a training run of the
port leaves checkpoints that carry the model's ``state_dict``, AdamW's
moments (``mu`` bf16, ``nu`` f32) and step count, the epoch, the
:class:`BestTracker` and the state of the Trainer's dropout stream (a CPU
``torch.Generator``, the JAX package's ``TrainState.rng``), so a run that
stops (a crash, a preemption) resumes where it stopped, and a server loads
what it trained.

A directory holds ``checkpoint_<step>.pt`` files, the newest
``max_to_keep`` of them. The best-validation model is kept apart under
``<dir>/best`` (:func:`best_dir`, one kept): after early stopping the latest
cadence checkpoint is a later state than the one the reported test metrics
describe, and serving loads ``best/`` by default.

One layout for every topology. In a multi-process run every rank calls
:meth:`CheckpointManager.save` and :meth:`CheckpointManager.restore`
together: a save gathers the tensor-parallel shards (parameters, and their
bf16 first and f32 second moments; parallel/megatron.py's tags say which)
into whole tensors through host copies, rank 0 alone writes the file, and
every rank waits for it at the next save, restore or
:meth:`CheckpointManager.wait_until_finished`; a restore loads the whole
tensors and keeps each rank's block. So a checkpoint written by several
processes serves and resumes in one, and the other way round. The
directory must be one that every rank sees.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

import torch
import torch.distributed as dist

from dostransformer_tpu_torch.parallel.megatron import local_block, shard_dim
from dostransformer_tpu_torch.parallel.mesh import gather_host, host_group
from dostransformer_tpu_torch.train.early_stop import BestTracker

#: subdirectory of a checkpoint directory that holds the best-validation
#: model (as in the JAX package)
BEST_SUBDIR = "best"
_FILE = re.compile(r"checkpoint_(\d+)\.pt")


def best_dir(directory: str) -> str:
    return os.path.join(directory, BEST_SUBDIR)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host that later steps cannot change."""
    return t.detach().to("cpu", copy=True)


def _whole(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` (a parameter or one of its moments, shaped
    like parameter ``like``), its shards gathered where ``like`` is a
    tensor-parallel shard."""
    dim = shard_dim(like)
    if dim is None:
        return _host_copy(t)
    return gather_host(t, like.tp_group, dim)


def _multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _writes() -> bool:
    """Whether this process writes the files (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """Save and restore (model, optimizer, epoch, tracker) under
    ``directory``, keeping the newest ``max_to_keep`` checkpoints."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pt")

    def _steps(self) -> list:
        """The steps on disk, ascending (a ``.tmp`` file is no checkpoint)."""
        found = (_FILE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, model: torch.nn.Module, optimizer=None,
             tracker: Optional[BestTracker] = None, wait: bool = False,
             epoch_meta: Optional[int] = None,
             rng: Optional[torch.Generator] = None) -> bool:
        """Checkpoint the model, the optimizer (an ``AdamW``), the tracker
        and the state of ``rng`` (a CPU generator, the same on every rank:
        the Trainer's ``dropout_rng``) at step ``epoch``.

        The tensors are copied to the host here, at the epoch boundary, so
        training may go on at once; the file is written on a background
        thread under a temporary name and renamed into place, so a crash
        mid-save never leaves a corrupt checkpoint. A save waits for the
        one before it; ``wait=True`` (or :meth:`wait_until_finished`) also
        waits for this one.

        As orbax does, a save at a step at or below the latest one on disk
        is refused (returns False, writes nothing); where the logical epoch
        does not increase (``best/`` after a resume restored an older
        state), pass a monotonic ordinal as ``epoch`` and the true epoch as
        ``epoch_meta``, which :meth:`restore` reports."""
        self.wait_until_finished()
        steps = self._steps()
        if steps and epoch <= steps[-1]:
            return False
        params = dict(model.named_parameters())
        state = {
            "step": epoch,
            "epoch": epoch if epoch_meta is None else epoch_meta,
            "model": {k: _whole(v, params.get(k, v))
                      for k, v in model.state_dict().items()},
            "optimizer": None,
            "tracker": tracker.to_dict() if tracker is not None else None,
            "rng": rng.get_state() if rng is not None else None,
        }
        if optimizer is not None:
            opt = optimizer.state_dict()
            state["optimizer"] = {"step_count": int(opt["step_count"])}
            for name in ("mu", "nu"):
                state["optimizer"][name] = torch.cat([
                    _whole(m.reshape(p.shape), p).reshape(-1)
                    for m, p in zip(opt[name].split(optimizer._sizes),
                                    optimizer.params)])
        if _writes():
            self._writer = threading.Thread(target=self._write,
                                            args=(epoch, state))
            self._writer.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, state: dict) -> None:
        try:
            path = self._path(step)
            tmp = f"{path}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self._steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # re-raised by wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the save in flight is on disk; raise if it failed.
        In a multi-process run every rank waits for rank 0's write."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if _multiprocess():
            dist.barrier(group=host_group())
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(
                f"writing a checkpoint under {self.directory} failed") from error

    def latest_epoch(self) -> Optional[int]:
        """The latest step on disk (a save in flight counts), or None."""
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, model: torch.nn.Module, optimizer=None,
                epoch: Optional[int] = None,
                rng: Optional[torch.Generator] = None):
        """Load the checkpoint at step ``epoch`` (default: the latest) into
        ``model`` and ``optimizer`` in place, onto the devices their tensors
        lie on, and the saved generator state into ``rng`` (left as it is
        where the checkpoint holds none). Returns (epoch, tracker), the
        epoch being the saved ``epoch_meta`` where one was given and the
        tracker None where none was saved; None when the directory holds no
        checkpoint."""
        self.wait_until_finished()
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                return None
        state = torch.load(self._path(epoch), map_location="cpu",
                           weights_only=True)
        params = dict(model.named_parameters())
        model.load_state_dict({k: local_block(v, params[k]) if k in params
                               else v for k, v in state["model"].items()},
                              strict=True)
        if optimizer is not None:
            if state["optimizer"] is None:
                raise ValueError(f"{self._path(epoch)} holds no optimizer "
                                 f"state")
            opt = dict(state["optimizer"])
            sizes = [_whole_shape(p).numel() for p in optimizer.params]
            for name in ("mu", "nu"):
                opt[name] = torch.cat([
                    local_block(m.reshape(_whole_shape(p)), p).reshape(-1)
                    for m, p in zip(opt[name].split(sizes),
                                    optimizer.params)])
            optimizer.load_state_dict(opt)
        if rng is not None and state.get("rng") is not None:
            rng.set_state(state["rng"])
        tracker = (BestTracker.from_dict(state["tracker"])
                   if state["tracker"] is not None else None)
        return state["epoch"], tracker


def _whole_shape(p: torch.Tensor) -> torch.Size:
    """The unsharded shape of parameter ``p``."""
    dim = shard_dim(p)
    if dim is None:
        return p.shape
    shape = list(p.shape)
    shape[dim] *= dist.get_world_size(p.tp_group)
    return torch.Size(shape)

