"""Model registry: (task, embedder) -> model.

Counterpart of dostransformer_tpu/models/registry.py. The port has the eDOS
and phDOS flagships; every other family raises NotImplementedError naming
the ROADMAP item that brings it.
"""

from __future__ import annotations

import torch
from torch import nn

from dostransformer_tpu_torch.models.dostransformer import (
    DOSTransformerEDOS,
    DOSTransformerPhDOS,
)

_FAMILIES = {
    "edos": ("dostransformer", "graphnetwork", "graphnetwork2", "mlp",
             "mlp2"),
    "phdos": ("dostransformer", "dostransformer_phonon", "graphnetwork",
              "graphnetwork2", "mlp", "mlp2"),
}
_PORTED = {("edos", "dostransformer"): DOSTransformerEDOS,
           ("phdos", "dostransformer"): DOSTransformerPhDOS,
           ("phdos", "dostransformer_phonon"): DOSTransformerPhDOS}


def build_model(task: str, embedder: str = "DOSTransformer", *,
                layers: int = 3, t_layers: int = 2, hidden: int = 256,
                **kwargs) -> nn.Module:
    """Instantiate a model by (task, embedder) name (case-insensitive).
    ``kwargs`` go to the model: padding, input widths, device, generator,
    the LayerNorm levers ``fuse_ln_attn`` and ``ln_lp``, and the options
    that are not ported yet (which raise)."""
    family = _FAMILIES.get(task.lower())
    if family is None:
        raise ValueError(f"unknown task {task!r}; choose from "
                         f"{sorted(_FAMILIES)}")
    name = embedder.lower()
    if name not in family:
        raise ValueError(f"Inappropriate model name {embedder!r} for task "
                         f"{task!r}; choose from {sorted(family)}")
    model = _PORTED.get((task.lower(), name))
    if model is None:
        raise NotImplementedError(
            f"({task!r}, {embedder!r}) is not in the PyTorch port yet; see "
            f"ROADMAP.md queue 1 item 7 (baselines)")
    return model(layers=layers, t_layers=t_layers, hidden=hidden, **kwargs)


def entry_device(device="cuda", how: str = 'device="cpu"') -> torch.device:
    """The device an entry point (a CLI, ``Predictor.from_torch``,
    ``run_training``) runs on: the card unless the caller names another. A
    CUDA device with no card visible raises and names ``how`` to ask for the
    CPU; an entry point never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible (torch.cuda.is_available() is "
            f"False) and the device asked for is {str(device)!r}; pass "
            f"{how} to run on the CPU")
    return device
