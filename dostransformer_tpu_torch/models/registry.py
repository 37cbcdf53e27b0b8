"""Model registry: (task, embedder) -> model.

Counterpart of dostransformer_tpu/models/registry.py (the reference's
if/elif selection, main_eDOS.py:66-88, main_phDOS.py:65-88), made
case-insensitive as the JAX package makes it: the two flagships and the
eight baselines.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn

from dostransformer_tpu_torch.models.dostransformer import (
    DOSTransformerEDOS,
    DOSTransformerPhDOS,
)
from dostransformer_tpu_torch.models.graphnetwork import (
    Graphnetwork2EDOS,
    GraphnetworkEDOS,
)
from dostransformer_tpu_torch.models.mlp import MLP2EDOS, MLPEDOS
from dostransformer_tpu_torch.models.phonon_baselines import (
    Graphnetwork2PhDOS,
    GraphnetworkPhDOS,
    MLP2PhDOS,
    MLPPhDOS,
)

MODEL_REGISTRY = {
    "edos": {
        "dostransformer": DOSTransformerEDOS,
        "graphnetwork": GraphnetworkEDOS,
        "graphnetwork2": Graphnetwork2EDOS,
        "mlp": MLPEDOS,
        "mlp2": MLP2EDOS,
    },
    "phdos": {
        "dostransformer": DOSTransformerPhDOS,
        "dostransformer_phonon": DOSTransformerPhDOS,
        "graphnetwork": GraphnetworkPhDOS,
        "graphnetwork2": Graphnetwork2PhDOS,
        "mlp": MLPPhDOS,
        "mlp2": MLP2PhDOS,
    },
}


def build_model(task: str, embedder: str = "DOSTransformer", *,
                layers: int = 3, t_layers: int = 2, hidden: int = 256,
                **kwargs) -> nn.Module:
    """Instantiate a model by (task, embedder) name (case-insensitive).
    ``kwargs`` go to the model: padding, input widths, device, generator,
    the LayerNorm levers ``fuse_ln_attn`` and ``ln_lp``, and the flagships'
    fields of the JAX registry (the baselines take none of them): the
    compute ``dtype`` ("float32", "bfloat16" or "float64"),
    ``attn_drop`` (the attention dropout of the three stacks),
    ``use_fused_mp`` (None auto, False the plain message-passing
    composition), ``tp_axis`` (the mesh axis the transformer FFNs shard
    over), and ``bins_pad``, which is not ported (it raises). As in the JAX
    package, each family is given only the arguments it takes: ``layers``
    only where it has processors, the transformer's only to the
    flagships."""
    family = MODEL_REGISTRY.get(task.lower())
    if family is None:
        raise ValueError(f"unknown task {task!r}; choose from "
                         f"{sorted(MODEL_REGISTRY)}")
    cls = family.get(embedder.lower())
    if cls is None:
        raise ValueError(f"Inappropriate model name {embedder!r} for task "
                         f"{task!r}; choose from {sorted(family)}")
    kwargs.update(layers=layers, t_layers=t_layers, hidden=hidden)
    params = inspect.signature(cls).parameters
    if not any(p.kind is p.VAR_KEYWORD for p in params.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in params}
    return cls(**kwargs)


def model_outputs(out):
    """(dos_global, node embeddings or None, dos_system or None) of any
    family's forward: the flagships return all three, graphnetwork and
    graphnetwork2 of eDOS (dos, node embeddings), the rest a bare dos."""
    if isinstance(out, torch.Tensor):
        return out, None, None
    if len(out) == 3:
        return tuple(out)
    dos, x = out
    return dos, x, None


def system_dos(out) -> torch.Tensor:
    """The spectrum a model serves and is scored on: the system head where
    there is one, else the one DOS."""
    dos_global, _, dos_system = model_outputs(out)
    return dos_global if dos_system is None else dos_system
