"""Pre-LN transformer encoder stack.

Counterpart of dostransformer_tpu/nn/transformer.py, batch-first ([B, L, D]):

  * Each layer: ONE LayerNorm (layer_norms.0) applied to q, k and v
    separately -> projection-free attention -> residual; layer_norms.1 ->
    FFN (4x widening, ReLU, xavier-uniform weights, zero bias) -> residual.
  * The key/value streams passed into the stack are FIXED across layers:
    each layer re-norms the original k/v inputs; only the query stream
    evolves.
  * A final LayerNorm (layer_norm) closes the stack.

Attention runs through :func:`~dostransformer_tpu_torch.ops.attention.
fused_attention`: the CUDA kernels (forward and backward) on the card, their
plain versions on the CPU. The shared LayerNorm of q, k and v is one module
applied three times, so its parameter gradient sums the three uses; when k
and v are one tensor, ln0 runs once for both. Attention dropout is not
ported (ROADMAP.md queue 1 item 2); training runs without it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dostransformer_tpu_torch.nn.init import xavier_linear_
from dostransformer_tpu_torch.nn.layernorm import LayerNorm
from dostransformer_tpu_torch.ops.attention import fused_attention


class XavierLinear(nn.Linear):
    """The transformer FFN Linear: xavier_uniform weight, zero bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if not self.weight.is_meta:
            xavier_linear_(self.weight, self.bias, generator)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.fc1 = XavierLinear(embed_dim, 4 * embed_dim)
        self.fc2 = XavierLinear(4 * embed_dim, embed_dim)
        self.layer_norms = nn.ModuleList([LayerNorm(embed_dim),
                                          LayerNorm(embed_dim)])

    def forward(self, x, x_k, x_v, key_mask: Optional[torch.Tensor] = None):
        ln0, ln1 = self.layer_norms
        k = ln0(x_k)
        v = k if x_v is x_k else ln0(x_v)
        x = x + fused_attention(ln0(x), k, v, key_mask)
        return x + self.fc2(F.relu(self.fc1(ln1(x))))


class TransformerEncoder(nn.Module):
    """Stack of TransformerEncoderLayers + final LayerNorm. k/v inputs are
    fixed across layers; with neither given the stack self-attends."""

    def __init__(self, embed_dim: int, layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(embed_dim)
                                    for _ in range(layers))
        self.layer_norm = LayerNorm(embed_dim)

    def forward(self, x_in, x_in_k=None, x_in_v=None,
                key_mask: Optional[torch.Tensor] = None):
        if (x_in_k is None) != (x_in_v is None):
            # one-sided k/v would silently degrade to full self-attention,
            # discarding the stream the caller DID supply
            raise ValueError("pass both x_in_k and x_in_v (cross-attention) "
                             "or neither (self-attention)")
        x = x_in
        x_k, x_v = (x, x) if x_in_k is None else (x_in_k, x_in_v)
        for layer in self.layers:
            x = layer(x, x_k, x_v, key_mask)
        return self.layer_norm(x)
