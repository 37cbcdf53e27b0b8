"""LayerNorm with f32 statistics.

Counterpart of the default path of dostransformer_tpu/nn/layernorm.py
`layer_norm`: statistics in float32 or wider whatever the operand dtype, the
output cast back to the operand dtype. The JAX package's low-precision
residual variant and its Pallas backward kernel are training-only and not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    f = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(f), x.shape[-1:], weight.to(f), bias.to(f),
                        eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (same parameters and state_dict keys) that normalises
    with :func:`layer_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
