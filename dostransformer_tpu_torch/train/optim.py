"""AdamW with the JAX package's semantics.

Counterpart of `make_adamw` in dostransformer_tpu/train/trainer.py (optax
``adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay, mu_dtype=bfloat16)``,
reference main_eDOS.py:93): decoupled weight decay on every parameter, the
first moment STORED in bfloat16 and the second in float32, and bias
correction with the integer step count. One step, in optax's order:

    mu  = (1 - b1) g + b1' mu          (f32, stored back as bf16)
    nu  = (1 - b2) g^2 + b2 nu         (f32)
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p  -= lr u

where b1' is b1 rounded to bfloat16 (0.9 -> 0.8984375): optax multiplies the
bf16 moment by the Python float b1, which JAX casts to the moment's dtype,
and the JAX package's jitted step keeps that product in f32. The port
follows the jitted step, so the two agree bit for bit in the stored moment.

``torch.optim.AdamW`` keeps both moments in the parameter dtype, so it is
not this optimizer. The moments live in two flat buffers; a step gathers the
gradients and parameters into flat tensors, updates them with a handful of
elementwise ops and copies the parameters back with one ``_foreach_copy_``,
so the launch count does not grow with the number of parameters.

The fine-tuning extensions of the JAX ``make_adamw`` (all off by default)
follow optax too: ``grad_clip`` clips the gradients to that global norm
before AdamW (``clip_by_global_norm``); ``warmup_steps`` and
``cosine_decay_steps`` make the learning rate a schedule of the step count
(:func:`learning_rate`), read at the count BEFORE the step, as optax's
``scale_by_learning_rate`` reads its own count. The schedule depends on the
count alone, which :meth:`AdamW.state_dict` saves with the moments, so a
resumed run continues it.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # torch's and optax's AdamW defaults


def learning_rate(count: int, lr: float, warmup_steps: int = 0,
                  cosine_decay_steps: int = 0) -> float:
    """The learning rate of the step taken at optimizer count ``count``
    (0 for the first step), computed in float32 as the JAX package's optax
    schedules compute it: with ``cosine_decay_steps`` optax's
    ``warmup_cosine_decay_schedule(0 or lr, lr, warmup_steps, warmup_steps
    + cosine_decay_steps, end_value=0)``; with ``warmup_steps`` alone
    ``join_schedules([linear_schedule(0, lr, warmup_steps),
    constant_schedule(lr)], [warmup_steps])``; else ``lr``."""
    f32 = np.float32
    c = f32(count)
    if cosine_decay_steps:
        if warmup_steps and count < warmup_steps:
            return float(f32(-lr) * (f32(1) - c / f32(warmup_steps))
                         + f32(lr))
        t = np.minimum(c - f32(warmup_steps), f32(cosine_decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t
                                             / f32(cosine_decay_steps)))
        return float(f32(lr) * cosine)
    if warmup_steps and count < warmup_steps:
        return float(f32(-lr) * (f32(1) - c / f32(warmup_steps)) + f32(lr))
    return lr


class AdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 weight_decay: float = 1e-2, *, grad_clip: float = 0.0,
                 warmup_steps: int = 0, cosine_decay_steps: int = 0):
        self.params = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("AdamW needs at least one parameter")
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("AdamW: parameters must be float32")
        for name, value in (("grad_clip", grad_clip),
                            ("warmup_steps", warmup_steps),
                            ("cosine_decay_steps", cosine_decay_steps)):
            if value < 0:
                raise ValueError(f"AdamW: {name} must be >= 0, got {value}")
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip = grad_clip
        self.warmup_steps, self.cosine_decay_steps = (warmup_steps,
                                                      cosine_decay_steps)
        # the decay as optax applies it to a bf16 moment (see above)
        self._b1_mu = float(torch.tensor(B1, dtype=torch.bfloat16))
        self.step_count = 0  # optax's integer count
        self._sizes = [p.numel() for p in self.params]
        n = sum(self._sizes)
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def moments(self, param: torch.nn.Parameter):
        """(mu, nu) of one parameter, shaped like it (views of the flat
        buffers)."""
        off = 0
        for p, n in zip(self.params, self._sizes):
            if p is param:
                return (self.mu[off:off + n].view_as(p),
                        self.nu[off:off + n].view_as(p))
            off += n
        raise KeyError("not a parameter of this optimizer")

    def state_dict(self) -> dict:
        """The optimizer's state: the flat moments (``mu`` bf16, ``nu``
        f32, in parameter order) and the step count, which alone sets the
        schedule."""
        return {"mu": self.mu, "nu": self.nu, "step_count": self.step_count}

    def load_state_dict(self, state: dict):
        """Copy a :meth:`state_dict` into this optimizer's buffers (on
        their device); the moments must have this optimizer's size."""
        for name in ("mu", "nu"):
            src, dst = state[name], getattr(self, name)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"AdamW.load_state_dict: {name} is {tuple(src.shape)} "
                    f"{src.dtype}, this optimizer's is {tuple(dst.shape)} "
                    f"{dst.dtype}")
            dst.copy_(src)
        self.step_count = int(state["step_count"])

    @torch.no_grad()
    def step(self):
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        p = torch.cat([p.reshape(-1) for p in self.params])
        if self.grad_clip > 0:  # optax.clip_by_global_norm, on the device
            norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.grad_clip, g,
                            g / norm * self.grad_clip)
        lr = learning_rate(self.step_count, self.lr, self.warmup_steps,
                           self.cosine_decay_steps)
        self.step_count += 1
        t = self.step_count
        # bias corrections in f32, as optax computes 1 - decay**count
        bc1 = float(np.float32(1) - np.float32(B1) ** np.int32(t))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.int32(t))
        mu = (1 - B1) * g + self._b1_mu * self.mu.float()
        nu = (1 - B2) * (g * g) + B2 * self.nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p = p + (u + self.weight_decay * p) * (-lr)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        torch._foreach_copy_(self.params,
                             [x.view_as(q) for x, q in
                              zip(p.split(self._sizes), self.params)])


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
               weight_decay: float = 1e-2, *, grad_clip: float = 0.0,
               warmup_steps: int = 0, cosine_decay_steps: int = 0) -> AdamW:
    """The JAX package's `make_adamw`, bound to ``params``: its defaults
    and its fine-tuning extensions (``grad_clip`` > 0 clips to that global
    norm first; ``warmup_steps`` > 0 warms the rate up linearly from 0;
    ``cosine_decay_steps`` > 0 decays it to 0 over the steps after the
    warmup). Horizons are optimizer steps; a negative value raises."""
    return AdamW(params, lr=lr, weight_decay=weight_decay,
                 grad_clip=grad_clip, warmup_steps=warmup_steps,
                 cosine_decay_steps=cosine_decay_steps)
