"""Parameter initialisers matching the reference's torch defaults.

Counterpart of dostransformer_tpu/nn/init.py. The reference mixes two Linear
schemes: torch's default (weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
everywhere except the transformer FFN, whose fc1/fc2 take xavier_uniform
weights and zero bias. Embeddings are N(0, 1); LayerNorm is ones/zeros;
PReLU's single slope starts at 0.25.

Every draw comes from the ``torch.Generator`` passed in, on the CPU, and is
then copied to the parameter's device, so a seed gives the same weights on
every device. Weights are torch-layout ``[out, in]``: fan_in is shape[1].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _uniform_(param: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    draw = torch.empty(param.shape, dtype=param.dtype).uniform_(
        -bound, bound, generator=generator)
    param.copy_(draw)


@torch.no_grad()
def torch_linear_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> None:
    """torch nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
    weight [out, in] and the bias."""
    bound = 1.0 / math.sqrt(weight.shape[1])
    _uniform_(weight, bound, generator)
    if bias is not None:
        _uniform_(bias, bound, generator)


@torch.no_grad()
def xavier_linear_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> None:
    """xavier_uniform weight [out, in] and zero bias (the transformer FFN)."""
    fan_out, fan_in = weight.shape
    _uniform_(weight, math.sqrt(6.0 / (fan_in + fan_out)), generator)
    if bias is not None:
        bias.zero_()


@torch.no_grad()
def embedding_(weight: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> None:
    """torch nn.Embedding default: N(0, 1)."""
    weight.copy_(torch.randn(weight.shape, dtype=weight.dtype,
                             generator=generator))


def init_parameters_(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter of ``module`` from ``generator``, in module
    order: each Linear by its own scheme (the port's TorchLinear and
    XavierLinear take the generator), Embeddings N(0, 1), LayerNorm and
    PReLU their defaults."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            embedding_(m.weight, generator)
        elif isinstance(m, (nn.LayerNorm, nn.PReLU)):
            m.reset_parameters()


def materialize_(module: nn.Module, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
    """A module built on the meta device, placed on ``device`` (the CPU by
    default) with every parameter drawn by :func:`init_parameters_`."""
    module.to_empty(device=device if device is not None else "cpu")
    init_parameters_(module, generator)
