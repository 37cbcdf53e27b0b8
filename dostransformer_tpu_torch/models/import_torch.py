"""Weights into the port: reference torch state_dicts and JAX param trees.

Counterpart of dostransformer_tpu/models/import_torch.py. The port's modules
carry the reference's names, so a state_dict saved from the reference
PyTorch model loads with ``load_state_dict`` once the reference's dead
parameters are dropped (:func:`load_reference_state_dict`).
:func:`state_dict_from_jax` converts a JAX package param tree into the same
names, so the two packages can be run on identical weights:

  JAX tree                          port state_dict key
  --------------------------------  ------------------------------------
  embeddings                        embeddings.weight
  prompt_token                      promt_token.weight (eDOS spelling),
                                    prompt_token.weight (phDOS spelling)
  GN_encoder.node_encoder.lin0      GN_encoder.node_encoder.0
    .prelu / .lin1                    .1 / .2   (Linear, PReLU, Linear)
  processor{i}                      stacked_processor.{i}
  *.edge_mlp.{lin0,ln,prelu,lin1}   *.edge_mlp.{0,1,2,3}
  GN_decoder.mlp                    GN_decoder.mlp.0
  decoder (MLPPhDOS, top level)     GN_decoder.mlp.0
  node_encoder, edge_encoder        GN_encoder.node_encoder, .edge_encoder
    (MLPPhDOS, top level)
  out0 / out1 (baselines)           out_layer.0 / out_layer.2 (index 1 is
                                    the parameter-free LeakyReLU)
  transformer*.layer{i}             transformer*.layers.{i}
  *.ln0.ln / *.ln1                  *.layer_norms.0 / .1
  *.final_ln                        *.layer_norm
  kernel [in, out]                  weight [out, in] (transposed)
  scale (LayerNorm), alpha (PReLU)  weight
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

_ENCODER_SEQ = {"lin0": "0", "prelu": "1", "lin1": "2"}
_MLP_BLOCK_SEQ = {"lin0": "0", "ln": "1", "prelu": "2", "lin1": "3"}
# the reference spells the prompt table per task
_PROMPT = {"edos": "promt_token", "phdos": "prompt_token"}


def _rename(key: str, siblings: set, task: str, top: bool) -> List[str]:
    """Port name components for one JAX tree key (``top``: a key of the
    model's own level)."""
    for seq in (_ENCODER_SEQ, _MLP_BLOCK_SEQ):
        if siblings == set(seq):
            return [seq[key]]
    for prefix, name in (("processor", "stacked_processor"),
                         ("layer", "layers")):
        if key.startswith(prefix) and key[len(prefix):].isdigit():
            return [name, key[len(prefix):]]
    if top and key == "decoder":  # MLPPhDOS flattens the reference's Decoder
        return ["GN_decoder", "mlp", "0"]
    if top and key in ("node_encoder", "edge_encoder"):
        return ["GN_encoder", key]  # and its Encoder
    return {"ln0": ["layer_norms", "0"], "ln1": ["layer_norms", "1"],
            "ln": [], "final_ln": ["layer_norm"], "mlp": ["mlp", "0"],
            "out0": ["out_layer", "0"], "out1": ["out_layer", "2"],
            "prompt_token": [_PROMPT[task]]}.get(key, [key])


def state_dict_from_jax(params: Mapping,
                        task: str = "edos") -> Dict[str, torch.Tensor]:
    """The JAX package's params of a model of ``task`` ("edos" or
    "phdos"; a flagship or a baseline), or of one of its modules
    (``{"params": tree}`` or the bare tree, nested dicts of arrays), as the
    port's state_dict of CPU tensors. ``task`` picks the prompt table's
    spelling."""
    task = task.lower()
    if task not in _PROMPT:
        raise ValueError(f"unknown task {task!r}; expected one of "
                         f"{sorted(_PROMPT)}")
    tree = params["params"] if set(params) == {"params"} else params
    out: Dict[str, torch.Tensor] = {}

    def put(name: List[str], arr, transpose: bool = False) -> None:
        arr = np.asarray(arr)
        out[".".join(name)] = torch.from_numpy(
            np.array(arr.T if transpose else arr))  # an owned, writable copy

    def walk(node, name: List[str]) -> None:
        if not isinstance(node, Mapping):
            put(name + ["weight"], node)  # an Embedding table
            return
        keys = set(node)
        if "kernel" in keys and keys <= {"kernel", "bias"}:  # Linear
            put(name + ["weight"], node["kernel"], transpose=True)
            if "bias" in keys:
                put(name + ["bias"], node["bias"])
        elif keys == {"scale", "bias"}:  # LayerNorm
            put(name + ["weight"], node["scale"])
            put(name + ["bias"], node["bias"])
        elif keys == {"alpha"}:  # PReLU
            put(name + ["weight"], node["alpha"])
        else:
            for k, child in node.items():
                walk(child, name + _rename(k, keys, task, node is tree))

    walk(tree, [])
    return out


def _is_dead_reference_key(key: str, has_decoder: bool = True) -> bool:
    """Reference parameters the forward never uses: the attention's
    in_proj/out_proj, NodeModel.node_mlp_1, the baselines'
    node_encoder_prompt, the free ``alpha``, fairseq's version buffer, and
    the Decoder of a model that never calls it (Graphnetwork2 builds one,
    graphnetwork.py:56 vs its forward :63-74): ``has_decoder`` False."""
    return (".self_attn." in key or ".node_mlp_1." in key
            or "node_encoder_prompt." in key or key == "alpha"
            or key == "version" or key.endswith(".version")
            or (not has_decoder and key.startswith("GN_decoder.")))


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping[str, torch.Tensor],
                              strict: bool = True):
    """Load a reference-format state_dict into a port model, dropping the
    reference's dead parameters first. Floating tensors are cast to the
    model's dtype: the reference trains phDOS in float64
    (main_phDOS.py:14-16), the port runs float32. Returns load_state_dict's
    result."""
    own = model.state_dict()
    has_decoder = any(k.startswith("GN_decoder.") for k in own)
    live = {}
    for k, v in state_dict.items():
        if _is_dead_reference_key(k, has_decoder):
            continue
        if k in own and v.is_floating_point():
            v = v.to(own[k].dtype)
        live[k] = v
    return model.load_state_dict(live, strict=strict)


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """Load a ``torch.save``d state_dict as CPU tensors.

    Accepts a bare state_dict or a ``{"state_dict": ...}`` checkpoint
    wrapper. Only tensors and plain containers are unpickled
    (``weights_only=True``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    inner = obj.get("state_dict") if isinstance(obj, Mapping) else None
    if (isinstance(inner, Mapping) and inner
            and all(torch.is_tensor(v) for v in inner.values())):
        obj = inner
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path!r} holds a {type(obj).__name__}, not a "
                         f"state_dict")
    out = {str(k): v.detach() for k, v in obj.items() if torch.is_tensor(v)}
    if not out:
        raise ValueError(f"{path!r} contained no tensors")
    return out
