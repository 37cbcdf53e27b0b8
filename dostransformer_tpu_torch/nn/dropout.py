"""Dropout whose masks come from an explicit generator.

Counterpart of ``flax.linen.Dropout`` and of the attention-weight dropout
in the JAX package's ``dot_product_attention``: a value is kept with
probability ``1 - rate`` and then scaled by ``1 / (1 - rate)``, a dropped
one is 0; at rate 1 everything is 0. ``F.dropout`` draws from the default
generator and takes no other, so the port draws each mask itself
(:func:`draw_keep`) from the generator the caller passes, on the operand's
device, and applies it apart (:func:`apply_keep`). A mask drawn apart can
be drawn outside a recomputed (``torch.utils.checkpoint``) call and handed
in, so the recomputation sees the same mask; and a test can hand in the
JAX package's own mask.
"""

from __future__ import annotations

from typing import Optional

import torch


def draw_keep(shape, rate: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``: True (keep) with
    probability ``1 - rate``, drawn from ``generator`` (which lives on
    ``device``)."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return u < (1.0 - rate)


def keep_scale(rate: float, dtype: torch.dtype) -> float:
    """``1 - rate`` as the operand's dtype holds it: JAX casts the Python
    scalar to the array's dtype before it divides, so a bf16 operand is
    divided by bf16(1 - rate)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor],
               rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in x's dtype; x itself where
    ``keep`` is None (no dropout in this call), zeros at rate 1."""
    if keep is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / keep_scale(rate, x.dtype), 0.0)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout of x at ``rate`` with a mask from ``generator``; x itself
    (the same tensor) at rate 0 or without a generator."""
    if rate <= 0.0 or generator is None:
        return x
    return apply_keep(x, draw_keep(x.shape, rate, generator, x.device), rate)
