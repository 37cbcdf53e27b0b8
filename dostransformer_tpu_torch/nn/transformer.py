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

Two switches, both off by default, are the JAX package's LayerNorm levers
(there read from ``DOSTPU_FUSE_LN_ATTN`` and ``DOSTPU_LN_LP`` /
``DOSTPU_LN_PALLAS`` inside the layer, here explicit arguments; the CLIs map
the environment names, see ``cli/common.py``):

  * ``fuse_ln_attn``: layer_norms.0's weight and bias go into
    :func:`~dostransformer_tpu_torch.ops.attention.fused_attention_ln`, which
    normalises q, k and v inside the attention forward kernel;
  * ``ln_lp``: layer_norms.0, layer_norms.1 and the stack's final LayerNorm
    are :class:`~dostransformer_tpu_torch.nn.layernorm.LayerNormLP`, whose
    backward is the single-pass kernel on the card.

With both on, layer_norms.0 lives in the fused kernel and layer_norms.1 and
the final LayerNorm go through ``layer_norm_lp``. Parameters and state_dict
keys are the same under every setting.

In a bf16 model the stack runs on bf16 activations: the FFN's weights are
cast at use, the LayerNorms take f32 statistics and cast back, and the
attention's scores and softmax are f32 (the bf16 forms of the attention
forward kernels on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dostransformer_tpu_torch.nn.init import xavier_linear_
from dostransformer_tpu_torch.nn.layernorm import LayerNorm, LayerNormLP
from dostransformer_tpu_torch.nn.modules import linear
from dostransformer_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_ln,
)


class XavierLinear(nn.Linear):
    """The transformer FFN Linear: xavier_uniform weight, zero bias; both
    cast to the operand's dtype at use (f32 parameters, bf16 products in a
    bf16 model)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if not self.weight.is_meta:
            xavier_linear_(self.weight, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, fuse_ln_attn: bool = False,
                 ln_lp: bool = False):
        super().__init__()
        norm = LayerNormLP if ln_lp else LayerNorm
        self.fuse_ln_attn = fuse_ln_attn
        self.fc1 = XavierLinear(embed_dim, 4 * embed_dim)
        self.fc2 = XavierLinear(4 * embed_dim, embed_dim)
        self.layer_norms = nn.ModuleList([norm(embed_dim), norm(embed_dim)])

    def forward(self, x, x_k, x_v, key_mask: Optional[torch.Tensor] = None):
        ln0, ln1 = self.layer_norms
        if self.fuse_ln_attn:
            x = x + fused_attention_ln(x, x_k, x_v, ln0.weight, ln0.bias,
                                       key_mask)
        else:
            k = ln0(x_k)
            v = k if x_v is x_k else ln0(x_v)
            x = x + fused_attention(ln0(x), k, v, key_mask)
        return x + self.fc2(F.relu(self.fc1(ln1(x))))


class TransformerEncoder(nn.Module):
    """Stack of TransformerEncoderLayers + final LayerNorm. k/v inputs are
    fixed across layers; with neither given the stack self-attends. With
    ``remat`` each layer is recomputed in the backward while gradients are
    recorded."""

    def __init__(self, embed_dim: int, layers: int = 2,
                 fuse_ln_attn: bool = False, ln_lp: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, fuse_ln_attn, ln_lp)
            for _ in range(layers))
        self.layer_norm = (LayerNormLP if ln_lp else LayerNorm)(embed_dim)

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
            if self.remat and torch.is_grad_enabled():
                # the layer keeps only its inputs and runs again in the
                # backward (the JAX package's flax.linen.remat per layer)
                x = checkpoint(layer, x, x_k, x_v, key_mask,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, x_k, x_v, key_mask)
        return self.layer_norm(x)
