"""Inference / serving path.

Counterpart of dostransformer_tpu/serve.py `Predictor` and
`ExportedPredictor`: load weights (a training run's checkpoint, a
``torch.save``d state_dict in the reference's naming, or a model in memory),
and predict DOS spectra for featurized crystals in fixed-shape padded
batches. Requests are grouped by atom padding bucket, so a mixed request of
small and large crystals pads each group only to its own shape; results come
back in input order with the dummy-graph rows of short batches dropped.
eDOS predictions are clamped at 0 (the reference's eval clamp); phDOS
predictions are not. A model built with ``dtype="bfloat16"`` (a keyword of
:meth:`Predictor.from_torch` and :meth:`Predictor.from_checkpoint`, passed to
the model as in the JAX package) serves in bf16 from the same f32 weights;
its spectra are f32.

On the card each input geometry is served through one CUDA graph with
streamed uploads and one copy to the host a request (serve_dispatch.py);
``graphs=False`` serves through the eager forward, as the CPU always does.
:meth:`Predictor.export` writes the served forward as a ``torch.export``
program with the weights in it; :class:`ExportedPredictor` (in
serve_dispatch.py, imported here) serves it without the model code.

Example:
    predictor = Predictor.from_torch("model.pt", task="edos",
                                     example=samples[0], device="cuda")
    spectra = predictor.predict(samples)           # [N, bins] numpy
    best = Predictor.from_checkpoint("ckpt/", task="edos",
                                     example=samples[0])  # ckpt/best
    predictor.export("artifact/", samples)
    ExportedPredictor("artifact/").predict(samples)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dostransformer_tpu_torch.data.datasets import GraphLoader
from dostransformer_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    RequestError,
    bucket_size,
)
from dostransformer_tpu_torch.device import entry_device
from dostransformer_tpu_torch.models.import_torch import (
    load_reference_state_dict,
    load_torch_state_dict,
)
from dostransformer_tpu_torch.models.registry import build_model, system_dos
from dostransformer_tpu_torch.serve_dispatch import (  # noqa: F401
    META,
    PROGRAM,
    Dispatch,
    ExportedPredictor,
    batch_leaves,
)


class ServingForward(torch.nn.Module):
    """A model's served spectrum over a batch's flat tensors (``names``
    gives their fields): the system head, clamped at 0 when ``clamp``. What
    a graph captures and what :meth:`Predictor.export` traces."""

    def __init__(self, model: torch.nn.Module, names: Sequence[str],
                 clamp: bool):
        super().__init__()
        self.model = model
        self.names = tuple(names)
        self.clamp = clamp

    def forward(self, *leaves: torch.Tensor) -> torch.Tensor:
        dos = system_dos(self.model(GraphBatch(**dict(zip(self.names,
                                                           leaves)))))
        return torch.clamp(dos, min=0.0) if self.clamp else dos


def _build_for(example: GraphSample, task, embedder, layers, t_layers,
               hidden, device, fuse_ln_attn, ln_lp, model_kwargs):
    """A model for ``task`` whose input widths are the example's."""
    widths = {"node_in": example.x.shape[1]}
    if example.edge_attr is not None:
        widths["edge_in"] = example.edge_attr.shape[1]
    if example.glob is not None:
        widths["glob_in"] = example.glob.shape[-1]
    return build_model(task, embedder, layers=layers, t_layers=t_layers,
                       hidden=hidden, device=device,
                       fuse_ln_attn=fuse_ln_attn, ln_lp=ln_lp, **widths,
                       **model_kwargs)


class Predictor(Dispatch):
    """Batched DOS inference over fixed-shape buckets, on the device the
    model's parameters lie on: through one CUDA graph per input geometry on
    a card (``graphs=False`` for the eager forward), eagerly on the CPU."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 8,
                 clamp: bool = False, graphs: bool = True):
        self.model = model.eval()
        self.clamp = clamp  # eDOS eval clamps predictions at 0, phDOS not
        super().__init__(next(model.parameters()).device, batch_size, graphs)
        self._fns: Dict[Tuple[str, ...], ServingForward] = {}

    def _forward_fn(self, names):
        if names not in self._fns:
            self._fns[names] = ServingForward(self.model, names, self.clamp)
        return self._fns[names]

    @classmethod
    def from_torch(
        cls,
        state_dict_path,
        task: str,
        example: GraphSample,
        embedder: str = "DOSTransformer",
        layers: int = 3,
        t_layers: int = 2,
        hidden: int = 256,
        batch_size: int = 8,
        device="cuda",
        strict: bool = True,
        fuse_ln_attn: bool = False,
        ln_lp: bool = False,
        graphs: bool = True,
        **model_kwargs,
    ) -> "Predictor":
        """Serve a ``torch.save``d state_dict in the reference's module
        naming (the port's own state_dicts use the same names). ``example``
        gives the input feature widths; the model-shape args must match the
        weights (a mismatch raises with the offending key). ``task`` is
        "edos" or "phdos"; phDOS weights saved in float64 by the reference
        load into the float32 model. ``fuse_ln_attn`` and ``ln_lp`` are the
        model's LayerNorm switches (nn/transformer.py); the weights load the
        same either way. ``model_kwargs`` go to the model (``padding``,
        ``dtype="bfloat16"`` for bf16 compute on f32 weights). The model
        runs on ``device``, the card by default; with no card visible this
        raises unless ``device="cpu"`` is given. ``graphs`` is the
        constructor's."""
        model = _build_for(example, task, embedder, layers, t_layers, hidden,
                           entry_device(device), fuse_ln_attn, ln_lp,
                           model_kwargs)
        load_reference_state_dict(model, load_torch_state_dict(state_dict_path),
                                  strict=strict)
        return cls(model, batch_size=batch_size, clamp=(task == "edos"),
                   graphs=graphs)

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        task: str,
        example: GraphSample,
        embedder: str = "DOSTransformer",
        layers: int = 3,
        t_layers: int = 2,
        hidden: int = 256,
        batch_size: int = 8,
        device="cuda",
        prefer: str = "best",
        fuse_ln_attn: bool = False,
        ln_lp: bool = False,
        graphs: bool = True,
        **model_kwargs,
    ) -> "Predictor":
        """Serve a training run's checkpoint (train/checkpoint.py layout).
        ``prefer="best"`` (the default) serves the best-validation model
        kept under ``<dir>/best``, the model the run's reported test
        metrics describe, falling back to the latest cadence checkpoint
        where no best was saved; ``prefer="latest"`` serves the newest
        cadence checkpoint. The other arguments are
        :meth:`from_torch`'s."""
        from dostransformer_tpu_torch.train.checkpoint import (
            CheckpointManager,
            best_dir,
        )

        if prefer not in ("best", "latest"):
            raise ValueError(f"prefer must be 'best' or 'latest', "
                             f"got {prefer!r}")
        model = _build_for(example, task, embedder, layers, t_layers, hidden,
                           entry_device(device), fuse_ln_attn, ln_lp,
                           model_kwargs)
        dirs = [checkpoint_dir]
        if prefer == "best":
            dirs.insert(0, best_dir(checkpoint_dir))
        for d in dirs:
            if os.path.isdir(d) and CheckpointManager(d).restore(model):
                return cls(model, batch_size=batch_size,
                           clamp=(task == "edos"), graphs=graphs)
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")

    def _forward(self, samples: List[GraphSample]) -> torch.Tensor:
        """[len(samples), bins] on the device, for samples of one padding
        shape."""
        return self._dispatch(GraphLoader(samples, self.batch_size),
                              len(samples))

    def predict(self, samples: Sequence[GraphSample],
                bucketed: bool = True) -> np.ndarray:
        """DOS spectra for the given samples, [N, bins], input order.

        ``bucketed`` (default): samples are grouped by their ATOM padding
        bucket (data/graph.py bucket_size; the edge slots then follow each
        group's own maximum) and each group runs at its own shape instead of
        the request-wide maxima."""
        samples = list(samples)
        if not samples:
            raise RequestError("empty request: no samples to predict")
        groups: Dict[int, List[int]] = {}
        for i, s in enumerate(samples):
            key = bucket_size(s.n_nodes) if bucketed else 0
            groups.setdefault(key, []).append(i)
        if len(groups) == 1:
            out = self._forward(samples)
        else:
            parts = [(idxs, self._forward([samples[i] for i in idxs]))
                     for idxs in groups.values()]
            out = parts[0][1].new_empty((len(samples), parts[0][1].shape[1]))
            for idxs, sub in parts:
                out[torch.as_tensor(idxs, device=out.device)] = sub
        return out.cpu().numpy()

    def export(self, path: str, example: Sequence[GraphSample]) -> None:
        """Write the served forward (the model with its weights, the system
        head and the eDOS clamp) as a ``torch.export`` program to
        ``path/forward.pt2``, traced under ``torch.no_grad`` on this
        predictor's device at the collation geometry of ``example`` (its
        atom and edge buckets at this batch size; a request beyond them is
        refused by :class:`ExportedPredictor`), and the geometry to
        ``path/serving_meta.json``: the JAX package's keys (batch_size,
        atoms_per_graph, edges_per_graph, bins, n_leaves, clamp) and the
        input fields, the device and the model's compute dtype. Each kernel
        of the forward is one ``dostpu`` op of the program."""
        loader = GraphLoader(list(example), self.batch_size)
        names, leaves = batch_leaves(next(iter(loader)).to(self.device))
        with torch.no_grad():
            program = torch.export.export(
                ServingForward(self.model, names, self.clamp), tuple(leaves))
        out = next(n for n in program.graph.nodes if n.op == "output")
        bins = int(out.args[0][0].meta["val"].shape[-1])
        os.makedirs(path, exist_ok=True)
        torch.export.save(program, os.path.join(path, PROGRAM))
        dtype = getattr(self.model, "cdtype", torch.float32)
        meta = {
            "batch_size": self.batch_size,
            "atoms_per_graph": loader.atoms_per_graph,
            "edges_per_graph": loader.edges_per_graph,
            "bins": bins,
            "n_leaves": len(leaves),
            "clamp": self.clamp,
            "leaves": list(names),
            "device": str(self.device),
            "dtype": str(dtype).removeprefix("torch."),
        }
        with open(os.path.join(path, META), "w") as f:
            json.dump(meta, f, indent=1)
