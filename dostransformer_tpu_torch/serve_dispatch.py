"""The serving dispatch on the card, and serving an exported program.

The counterpart of dostransformer_tpu/serve.py's jit per bucket shape,
``_stream_dispatch`` and ``_assemble``, shared by ``serve.Predictor`` and
:class:`ExportedPredictor` (as the JAX package shares them): each input
geometry (batch, atoms a graph, edges a graph; the model's dtype is fixed per
predictor) gets one CUDA graph of the whole served forward, captured at the
first batch of that geometry after one eager warm-up run, all graphs of a
predictor in one memory pool. A batch is collated on the host, copied into
one slot of a small ring of pinned buffers, uploaded into the graph's static
inputs without blocking the host, and the graph replayed; its rows are
copied, on the stream, into the request's output on the device. So the host
collates batch i+1 while the card runs batch i, and the request's output
reaches the host in one copy at the end. A capture or replay that fails
raises: nothing falls back to the eager forward. ``graphs=False`` serves
through the eager forward with a plain upload per batch (the oracle of the
graph path), and the CPU always does.

The JAX package's scan over chunks of batches is not ported: it amortised
dispatches on the TPU, and a graph replay is already one launch.

:class:`ExportedPredictor` serves a ``serve.Predictor.export`` artifact
(``forward.pt2``, a ``torch.export`` program with the weights in it, and
``serving_meta.json``, its collation geometry) without the model code: this
module imports no module of ``models/`` or ``train/``, only the ops that
register the program's ``dostpu`` kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dostransformer_tpu_torch.data.datasets import GraphLoader
from dostransformer_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    RequestError,
)
from dostransformer_tpu_torch.device import entry_device

PROGRAM, META = "forward.pt2", "serving_meta.json"


def batch_leaves(batch: GraphBatch
                 ) -> Tuple[Tuple[str, ...], List[torch.Tensor]]:
    """(field names, tensors) of the fields a batch has, in field order: the
    flat inputs of the served forward, as the graphs and exported programs
    take them."""
    names = tuple(f.name for f in dataclasses.fields(batch)
                  if getattr(batch, f.name) is not None)
    return names, [getattr(batch, n) for n in names]


class _Captured:
    """One geometry's graph: static inputs on the card, the ring of pinned
    host slots that feed them, the graph and its static output."""

    def __init__(self, leaves: List[torch.Tensor], device, ring: int):
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=device)
                       for x in leaves]
        self.ring = [([torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                       for x in leaves], torch.cuda.Event())
                     for _ in range(ring)]
        self.turn = 0
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def upload(self, leaves: List[torch.Tensor]) -> None:
        """Fill the next ring slot on the host and copy it into the static
        inputs without blocking the host. The slot's event was recorded
        after its last copy: the host waits for that copy before it writes
        the slot again."""
        bufs, copied = self.ring[self.turn % len(self.ring)]
        self.turn += 1
        copied.synchronize()
        for buf, x in zip(bufs, leaves):
            buf.copy_(x)
        for dst, buf in zip(self.static, bufs):
            dst.copy_(buf, non_blocking=True)
        copied.record()


class GraphCache:
    """One CUDA graph per input geometry, captured lazily (after one eager
    warm-up run of that geometry on a side stream, which also builds the
    kernel library and sets the kernels' attributes), every graph in one
    memory pool. Capture runs in ``thread_local`` error mode, so CUDA calls
    of other threads (a server's) do not break it. Counts in
    ``len(cache)``."""

    RING = 2  # pinned slots a geometry: one filling while one uploads

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.captured: Dict[tuple, _Captured] = {}

    def __len__(self) -> int:
        return len(self.captured)

    def run(self, fn: Callable, names: Tuple[str, ...],
            leaves: List[torch.Tensor]) -> torch.Tensor:
        """fn(*leaves) through its graph; returns the graph's static output,
        valid until the next replay of the same graph (copy it out on the
        stream before then)."""
        key = (names, tuple((tuple(x.shape), x.dtype) for x in leaves))
        with torch.cuda.device(self.device):  # one cache a card
            entry = self.captured.get(key)
            if entry is None:
                entry = _Captured(leaves, self.device, self.RING)
                entry.upload(leaves)
                self._capture(fn, entry, key)
                self.captured[key] = entry
            else:
                entry.upload(leaves)
            entry.graph.replay()
        return entry.out

    def _capture(self, fn, entry: _Captured, key) -> None:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(*entry.static)  # the eager warm-up
        stream.wait_stream(side)
        try:
            with torch.cuda.graph(entry.graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                entry.out = fn(*entry.static)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the served forward "
                               f"failed at inputs {key}: {e}") from e


class Dispatch:
    """The streamed dispatch shared by :class:`serve.Predictor` and
    :class:`ExportedPredictor`: graphs on a CUDA device unless ``graphs`` is
    False, the eager forward with a plain upload otherwise."""

    def __init__(self, device: torch.device, batch_size: int, graphs: bool):
        self.device = device
        self.batch_size = batch_size
        self.graphs = GraphCache(device) if (
            graphs and device.type == "cuda") else None

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured so far (one per input geometry)."""
        return 0 if self.graphs is None else len(self.graphs)

    def _forward_fn(self, names: Tuple[str, ...]) -> Callable:
        raise NotImplementedError

    def _run(self, batch: GraphBatch) -> torch.Tensor:
        """The served forward of one (host) batch on this device: through
        its geometry's graph, or eagerly; the output on the device."""
        names, leaves = batch_leaves(batch)
        fn = self._forward_fn(names)
        if self.graphs is not None:
            return self.graphs.run(fn, names, leaves)
        return fn(*(x.to(self.device) for x in leaves))

    @torch.inference_mode()
    def _dispatch(self, loader: GraphLoader, n: int) -> torch.Tensor:
        """[n, bins] on the device for the n samples the loader collates:
        one forward per batch, each batch's real rows copied (on the stream)
        into one output."""
        out = None
        for start, batch in zip(range(0, n, self.batch_size), loader):
            dos = self._run(batch)
            if out is None:
                out = dos.new_empty((n, dos.shape[1]))
            # collate puts the real samples first: drop the dummy rows
            rows = min(self.batch_size, n - start)
            out[start: start + rows].copy_(dos[:rows])
        return out


def _register_ops() -> None:
    """Import the modules that register the ``dostpu`` ops an exported
    program calls (and nothing of the model code)."""
    from dostransformer_tpu_torch.ops import (  # noqa: F401
        attention,
        ffn,
        fused_mp,
        segment,
    )


class ExportedPredictor(Dispatch):
    """Serve a :meth:`serve.Predictor.export` artifact without the model code.

    Loads the program (weights in it) and its collation geometry and serves
    through the same dispatch as :class:`serve.Predictor`: one CUDA graph on
    a card (``graphs=False`` for the eager program), the eager program on
    the CPU. ``device`` is the card by default (with none visible this
    raises unless ``device="cpu"``); a program exported on another device
    is moved to it (``torch.export.passes.move_to_device_pass``).
    ``predict`` matches :meth:`serve.Predictor.predict` at the export's
    geometry; a request beyond it raises RequestError."""

    def __init__(self, path: str, device="cuda", graphs: bool = True):
        _register_ops()
        with open(os.path.join(path, META)) as f:
            self.meta = json.load(f)
        device = entry_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        program = torch.export.load(os.path.join(path, PROGRAM))
        if torch.device(self.meta["device"]) != device:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        self._program = program.module()
        self.clamp = self.meta["clamp"]
        super().__init__(device, self.meta["batch_size"], graphs)

    def _forward_fn(self, names):
        if list(names) != self.meta["leaves"]:
            raise ValueError(
                f"collated batch has fields {list(names)}, the artifact "
                f"takes {self.meta['leaves']} — task/featurization mismatch")
        return self._program

    def predict(self, samples: Sequence[GraphSample]) -> np.ndarray:
        """DOS spectra [N, bins], input order; the same streamed dispatch
        and single fetch as :meth:`serve.Predictor.predict`, at the
        artifact's one geometry."""
        samples = list(samples)
        if not samples:
            raise RequestError("empty request: no samples to predict")
        loader = GraphLoader(samples, self.batch_size,
                             atoms_per_graph=self.meta["atoms_per_graph"],
                             edges_per_graph=self.meta["edges_per_graph"])
        return self._dispatch(loader, len(samples)).cpu().numpy()
