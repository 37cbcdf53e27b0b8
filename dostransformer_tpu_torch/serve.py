"""Inference / serving path.

Counterpart of dostransformer_tpu/serve.py `Predictor`: load weights (a
training run's checkpoint, a ``torch.save``d state_dict in the reference's
naming, or a model in memory),
and predict DOS spectra for featurized crystals in fixed-shape padded
batches. Requests are grouped by atom padding bucket, so a mixed request of
small and large crystals pads each group only to its own shape; results come
back in input order with the dummy-graph rows of short batches dropped.
Outputs stay on the device until the whole request is done and are copied
to the host once per call. eDOS predictions are clamped at 0 (the
reference's eval clamp); phDOS predictions are not.

Example:
    predictor = Predictor.from_torch("model.pt", task="edos",
                                     example=samples[0], device="cuda")
    spectra = predictor.predict(samples)           # [N, bins] numpy
    best = Predictor.from_checkpoint("ckpt/", task="edos",
                                     example=samples[0])  # ckpt/best
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from dostransformer_tpu_torch.data.datasets import GraphLoader
from dostransformer_tpu_torch.data.graph import (
    GraphSample,
    RequestError,
    bucket_size,
)
from dostransformer_tpu_torch.models.import_torch import (
    load_reference_state_dict,
    load_torch_state_dict,
)
from dostransformer_tpu_torch.models.registry import (
    build_model,
    entry_device,
    system_dos,
)


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


class Predictor:
    """Batched DOS inference over fixed-shape buckets, on the device the
    model's parameters lie on."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 8,
                 clamp: bool = False):
        self.model = model.eval()
        self.batch_size = batch_size
        self.clamp = clamp  # eDOS eval clamps predictions at 0, phDOS not
        self.device = next(model.parameters()).device

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
        **model_kwargs,
    ) -> "Predictor":
        """Serve a ``torch.save``d state_dict in the reference's module
        naming (the port's own state_dicts use the same names). ``example``
        gives the input feature widths; the model-shape args must match the
        weights (a mismatch raises with the offending key). ``task`` is
        "edos" or "phdos"; phDOS weights saved in float64 by the reference
        load into the float32 model. ``fuse_ln_attn`` and ``ln_lp`` are the
        model's LayerNorm switches (nn/transformer.py); the weights load the
        same either way. The model runs on ``device``, the card by default;
        with no card visible this raises unless ``device="cpu"`` is given."""
        model = _build_for(example, task, embedder, layers, t_layers, hidden,
                           entry_device(device), fuse_ln_attn, ln_lp,
                           model_kwargs)
        load_reference_state_dict(model, load_torch_state_dict(state_dict_path),
                                  strict=strict)
        return cls(model, batch_size=batch_size, clamp=(task == "edos"))

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
                           clamp=(task == "edos"))
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")

    @torch.inference_mode()
    def _forward(self, samples: List[GraphSample]) -> torch.Tensor:
        """[len(samples), bins] on the device, for samples of one padding
        shape: one forward per batch of the loader."""
        outs = []
        for start, batch in zip(range(0, len(samples), self.batch_size),
                                GraphLoader(samples, self.batch_size)):
            dos = system_dos(self.model(batch.to(self.device)))
            if self.clamp:
                dos = torch.clamp(dos, min=0.0)
            # collate puts the real samples first: drop the dummy rows
            outs.append(dos[: min(self.batch_size, len(samples) - start)])
        return torch.cat(outs, 0)

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
