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
and v are one tensor, ln0 runs once for both.

The JAX layer's other options, under its names (all off by default; none
adds a parameter, so a state_dict loads into every setting):

  * ``num_heads``: attention split into h heads as the JAX layer splits it,
    ``[B, L, D] -> [B*h, L, D/h]`` with the heads inner and the key mask
    repeated per head in that order, then merged back; each head is a call
    of the attention kernels at D/h. One head is the reference's
    projection-free attention.
  * ``attn_dropout`` on the attention weights, ``res_dropout`` after the
    attention (res_drop0) and after fc2 (res_drop1), ``relu_dropout`` after
    the ReLU, and the stack's ``embed_dropout`` on its inputs (embed_drop on
    the queries, embed_drop_k and embed_drop_v on the keys and values of a
    cross-attention: two draws, so keys and values are then two tensors).
    Dropout runs only in training mode and only with a generator handed to
    the stack's forward: the masks are drawn from it (nn/dropout.py), each
    layer's before the layer runs and handed in (:class:`LayerMasks`), so a
    layer that ``remat`` recomputes in the backward sees its forward's
    masks (``torch.utils.checkpoint`` would replay the draws from the
    generator's later state). A call with attention dropout takes the plain
    attention (:func:`~dostransformer_tpu_torch.ops.attention.
    masked_attention`), as the JAX package does; without it the kernels.

Two switches, both off by default, are the JAX package's LayerNorm levers
(there read from ``DOSTPU_FUSE_LN_ATTN`` and ``DOSTPU_LN_LP`` /
``DOSTPU_LN_PALLAS`` inside the layer, here explicit arguments; the CLIs map
the environment names, see ``cli/common.py``):

  * ``fuse_ln_attn``: layer_norms.0's weight and bias go into
    :func:`~dostransformer_tpu_torch.ops.attention.fused_attention_ln`, which
    normalises q, k and v inside the attention forward kernel; taken, as in
    the JAX layer, only with one head and no attention dropout in the call
    (a dropout model's training steps run unfused, its eval fused);
  * ``ln_lp``: layer_norms.0, layer_norms.1 and the stack's final LayerNorm
    are :class:`~dostransformer_tpu_torch.nn.layernorm.LayerNormLP`, whose
    backward is the single-pass kernel on the card.

With both on, layer_norms.0 lives in the fused kernel and layer_norms.1 and
the final LayerNorm go through ``layer_norm_lp``. Parameters and state_dict
keys are the same under every setting.

Tensor parallelism (the JAX package's ``tp_axis``): a layer built with
``tp_axis`` holds the whole FFN until :func:`shard_ffn_` splits it over a
process group (the mesh's ``tp_axis`` ranks): fc1 column-parallel (the rank
keeps 4D/tp of its output features, weight rows and bias), fc2 row-parallel
(4D/tp of its input features, weight columns; its bias whole). The FFN
input enters through ``tp_enter``, and ``tp_exit`` completes fc2's product
BEFORE the bias is added (adding it on every rank would count it tp times).
Unsharded, the layer computes the plain FFN.

The layer chooses which ops run; each op chooses kernel, cuBLAS or plain
version from its operands (the f64 rule is stated in ops/kernels.py). The
FFN, unsharded and with no ReLU dropout mask in the call, is one op,
:func:`~dostransformer_tpu_torch.ops.ffn.ffn`; the tensor-parallel FFN and
a ReLU dropout mask run the composition of two linears.

In a bf16 model the stack runs on bf16 activations: the FFN's weights are
cast at use, the LayerNorms take f32 statistics and cast back, and the
attention's scores and softmax are f32 (the bf16 forms of the attention
forward kernels on the card). An f64 model runs the LN-fused lever
unfused; its softmax is f32 unless ``DOSTPU_SOFTMAX_WIDE=1``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dostransformer_tpu_torch.nn.dropout import apply_keep, draw_keep, dropout
from dostransformer_tpu_torch.nn.init import xavier_linear_
from dostransformer_tpu_torch.nn.layernorm import LayerNorm, LayerNormLP
from dostransformer_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_ln,
    masked_attention,
)
from dostransformer_tpu_torch.ops.ffn import ffn
from dostransformer_tpu_torch.ops.kernels import takes_kernels
from dostransformer_tpu_torch.ops.linear import linear
from dostransformer_tpu_torch.parallel.megatron import (
    shard_parameter,
    tp_enter,
    tp_exit,
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


class LayerMasks(NamedTuple):
    """One layer's dropout keep masks for one call (None: no dropout
    there): the attention weights [B*h, Lq, Lk], res_drop0 and res_drop1
    [B, Lq, D], relu_drop [B, Lq, fc1's output features on this rank]."""

    attn: Optional[torch.Tensor] = None
    res0: Optional[torch.Tensor] = None
    relu: Optional[torch.Tensor] = None
    res1: Optional[torch.Tensor] = None


def split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, D] -> [B*h, L, D/h], heads inner (the JAX layer's split)."""
    b, n, d = t.shape
    return (t.reshape(b, n, h, d // h).transpose(1, 2)
            .reshape(b * h, n, d // h))


def merge_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """The inverse of :func:`split_heads`: [B*h, L, D/h] -> [B, L, D]."""
    bh, n, dh = t.shape
    return (t.reshape(bh // h, h, n, dh).transpose(1, 2)
            .reshape(bh // h, n, h * dh))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, fuse_ln_attn: bool = False,
                 ln_lp: bool = False, tp_axis: Optional[str] = None, *,
                 num_heads: int = 1, attn_dropout: float = 0.0,
                 relu_dropout: float = 0.0, res_dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        norm = LayerNormLP if ln_lp else LayerNorm
        self.fuse_ln_attn = fuse_ln_attn
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.relu_dropout = relu_dropout
        self.res_dropout = res_dropout
        self.tp_axis = tp_axis
        self.tp_group = None  # set by shard_ffn_
        self.fc1 = XavierLinear(embed_dim, 4 * embed_dim)
        self.fc2 = XavierLinear(4 * embed_dim, embed_dim)
        self.layer_norms = nn.ModuleList([norm(embed_dim), norm(embed_dim)])

    def draw_masks(self, x: torch.Tensor, x_k: torch.Tensor,
                   generator: torch.Generator) -> LayerMasks:
        """This layer's keep masks for queries x [B, Lq, D] and keys x_k
        [B, Lk, D], drawn from ``generator`` in a fixed order (attention,
        res_drop0, relu_drop, res_drop1); None where the rate is 0."""
        b, lq, d = x.shape
        shapes = {"attn": (self.attn_dropout,
                           (b * self.num_heads, lq, x_k.shape[1])),
                  "res0": (self.res_dropout, (b, lq, d)),
                  "relu": (self.relu_dropout,
                           (b, lq, self.fc1.weight.shape[0])),
                  "res1": (self.res_dropout, (b, lq, d))}
        return LayerMasks(**{
            name: draw_keep(shape, rate, generator, x.device)
            for name, (rate, shape) in shapes.items() if rate > 0.0})

    def _attend(self, q, k, v, key_mask, keep):
        """Attention of q over (k, v), split into heads: the attention op;
        with a keep mask the plain attention with dropout (the masks are
        per head)."""
        h = self.num_heads
        if h > 1:
            v = None if v is k else split_heads(v, h)
            q, k = split_heads(q, h), split_heads(k, h)
            v = k if v is None else v
            if key_mask is not None:
                key_mask = key_mask.repeat_interleave(h, dim=0)
        if keep is None:
            a = fused_attention(q, k, v, key_mask)
        else:
            a = masked_attention(q, k, v, key_mask, keep, self.attn_dropout)
        return merge_heads(a, h) if h > 1 else a

    def forward(self, x, x_k, x_v, key_mask: Optional[torch.Tensor] = None,
                masks: Optional[LayerMasks] = None):
        masks = masks or LayerMasks()
        ln0, ln1 = self.layer_norms
        if (self.fuse_ln_attn and masks.attn is None
                and self.num_heads == 1 and takes_kernels(x.dtype)):
            # the JAX rule: LN-fused only without attention dropout in this
            # call and with one head; never for f64 operands
            a = fused_attention_ln(x, x_k, x_v, ln0.weight, ln0.bias,
                                   key_mask)
        else:
            k = ln0(x_k)
            v = k if x_v is x_k else ln0(x_v)
            a = self._attend(ln0(x), k, v, key_mask, masks.attn)
        x = x + apply_keep(a, masks.res0, self.res_dropout)
        group = self.tp_group
        if group is None:
            y = ln1(x)
            if masks.relu is None:
                h = ffn(y, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                        self.fc2.bias)
            else:
                h = F.relu(self.fc1(y))
                h = self.fc2(apply_keep(h, masks.relu, self.relu_dropout))
            return x + apply_keep(h, masks.res1, self.res_dropout)
        h = F.relu(self.fc1(tp_enter(ln1(x), group)))
        h = apply_keep(h, masks.relu, self.relu_dropout)
        h = tp_exit(linear(h, self.fc2.weight, None), group)
        h = h + self.fc2.bias.to(h.dtype)
        return x + apply_keep(h, masks.res1, self.res_dropout)


class TransformerEncoder(nn.Module):
    """Stack of TransformerEncoderLayers + final LayerNorm. k/v inputs are
    fixed across layers; with neither given the stack self-attends. With
    ``remat`` each layer is recomputed in the backward while gradients are
    recorded. Dropout (the rates; see the module docstring) runs in
    training mode when the forward is given a ``generator``."""

    def __init__(self, embed_dim: int, layers: int = 2,
                 fuse_ln_attn: bool = False, ln_lp: bool = False,
                 remat: bool = False, tp_axis: Optional[str] = None, *,
                 num_heads: int = 1, attn_dropout: float = 0.0,
                 relu_dropout: float = 0.0, res_dropout: float = 0.0,
                 embed_dropout: float = 0.0):
        super().__init__()
        self.remat = remat
        self.embed_dropout = embed_dropout
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                embed_dim, fuse_ln_attn, ln_lp, tp_axis, num_heads=num_heads,
                attn_dropout=attn_dropout, relu_dropout=relu_dropout,
                res_dropout=res_dropout)
            for _ in range(layers))
        self.layer_norm = (LayerNormLP if ln_lp else LayerNorm)(embed_dim)

    def forward(self, x_in, x_in_k=None, x_in_v=None,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if (x_in_k is None) != (x_in_v is None):
            # one-sided k/v would silently degrade to full self-attention,
            # discarding the stream the caller DID supply
            raise ValueError("pass both x_in_k and x_in_v (cross-attention) "
                             "or neither (self-attention)")
        if not self.training:
            generator = None
        rate = self.embed_dropout
        x = dropout(x_in, rate, generator)  # embed_drop
        if x_in_k is None:
            x_k = x_v = x
        else:  # embed_drop_k, embed_drop_v: two draws
            x_k = dropout(x_in_k, rate, generator)
            x_v = dropout(x_in_v, rate, generator)
        for layer in self.layers:
            # drawn here, outside a recomputed call (see the module
            # docstring)
            masks = (None if generator is None
                     else layer.draw_masks(x, x_k, generator))
            if self.remat and torch.is_grad_enabled():
                # the layer keeps only its inputs and runs again in the
                # backward (the JAX package's flax.linen.remat per layer)
                x = checkpoint(layer, x, x_k, x_v, key_mask, masks,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, x_k, x_v, key_mask, masks)
        return self.layer_norm(x)


def unsharded_ffns(module: nn.Module, axis: str) -> list:
    """The layers in ``module`` built with ``tp_axis == axis`` whose FFN
    is whole."""
    return [layer for layer in module.modules()
            if isinstance(layer, TransformerEncoderLayer)
            and layer.tp_axis == axis and layer.tp_group is None]


def shard_ffn_(module: nn.Module, axis: str, group) -> int:
    """Split, in place, the whole FFN of every layer in ``module`` built
    with ``tp_axis == axis`` over the ranks of ``group`` (see the module
    docstring); the new parameters carry their shard tags
    (parallel/megatron.py). Call it before an optimizer takes the
    parameters. Returns the number of layers it split."""
    layers = unsharded_ffns(module, axis)
    for layer in layers:
        layer.fc1.weight = shard_parameter(layer.fc1.weight, 0, group)
        layer.fc1.bias = shard_parameter(layer.fc1.bias, 0, group)
        layer.fc2.weight = shard_parameter(layer.fc2.weight, 1, group)
        layer.tp_group = group
    return len(layers)
