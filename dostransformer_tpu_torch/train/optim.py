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
not this optimizer. Under data parallelism :meth:`AdamW.step` sums the flat
gradient over the data ranks first (``grad_group``); a sharded parameter's
moments are those of its shard. The moments live in two flat buffers; a step gathers the
gradients and parameters into flat tensors, updates them with a handful of
elementwise ops and copies the parameters back with one ``_foreach_copy_``,
so the launch count does not grow with the number of parameters.

The fine-tuning extensions of the JAX ``make_adamw`` (all off by default)
follow optax too: ``grad_clip`` clips the gradients to that global norm
before AdamW (``clip_by_global_norm``; under tensor parallelism the norm of
the whole model: the squares of each FFN shard summed over its ranks, every
replicated parameter counted once, so every rank clips by the unsharded
model's norm and the replicated parameters stay equal across ranks); ``warmup_steps`` and
``cosine_decay_steps`` make the learning rate a schedule of the step count
(:func:`learning_rate`), read at the count BEFORE the step, as optax's
``scale_by_learning_rate`` reads its own count. The schedule depends on the
count alone, which :meth:`AdamW.state_dict` saves with the moments, so a
resumed run continues it.

``x64`` is what the JAX package's ``--x64`` (``jax_enable_x64``) does to
optax: the scalars that optax derives from the int32 step count where JAX
then promotes to its default float, the bias corrections ``1 - b^t`` and
the cosine decay, are computed in float64 and rounded to f32 where they
meet the f32 moments (the linear warmup divides int32 by an int, which
stays f32 under x64 too); without it they are f32 throughout. The moments,
parameters and gradients stay f32 either way.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from dostransformer_tpu_torch.parallel.megatron import shard_dim

B1, B2, EPS = 0.9, 0.999, 1e-8  # torch's and optax's AdamW defaults


def learning_rate(count: int, lr: float, warmup_steps: int = 0,
                  cosine_decay_steps: int = 0, x64: bool = False) -> float:
    """The learning rate of the step taken at optimizer count ``count``
    (0 for the first step), computed in float32 as the JAX package's optax
    schedules compute it (the cosine decay in float64 and then rounded to
    f32 with ``x64``): with ``cosine_decay_steps`` optax's
    ``warmup_cosine_decay_schedule(0 or lr, lr, warmup_steps, warmup_steps
    + cosine_decay_steps, end_value=0)``; with ``warmup_steps`` alone
    ``join_schedules([linear_schedule(0, lr, warmup_steps),
    constant_schedule(lr)], [warmup_steps])``; else ``lr``."""
    f32 = np.float32
    if warmup_steps and count < warmup_steps:
        return float(f32(-lr) * (f32(1) - f32(count) / f32(warmup_steps))
                     + f32(lr))
    if cosine_decay_steps:
        f = np.float64 if x64 else f32
        t = np.minimum(f(count) - f(warmup_steps), f(cosine_decay_steps))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * t
                                         / f(cosine_decay_steps)))
        return float(f32(f(lr) * cosine))
    return lr


def bias_correction(decay: float, count: int, x64: bool = False) -> float:
    """optax's ``1 - decay**count`` as the f32 that divides the moment: in
    f32, or with ``x64`` in f64 and then rounded to f32."""
    if x64:
        return float(np.float32(1.0 - decay ** count))
    return float(np.float32(1) - np.float32(decay) ** np.int32(count))


class AdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 weight_decay: float = 1e-2, *, grad_clip: float = 0.0,
                 warmup_steps: int = 0, cosine_decay_steps: int = 0,
                 x64: bool = False):
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
        self.x64 = x64
        # the decay as optax applies it to a bf16 moment (see above)
        self._b1_mu = float(torch.tensor(B1, dtype=torch.bfloat16))
        self.step_count = 0  # optax's integer count
        self._sizes = [p.numel() for p in self.params]
        self._offsets = np.cumsum([0] + self._sizes[:-1]).tolist()
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

    def _global_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The gradient's norm over the WHOLE model: a tensor-parallel
        shard's squares are summed over its group, every other parameter
        (replicated, the same on every rank) counts once."""
        shards = [(off, n, p.tp_group) for off, n, p in
                  zip(self._offsets, self._sizes, self.params)
                  if shard_dim(p) is not None]
        if not shards:
            return torch.linalg.vector_norm(g)
        whole = torch.ones_like(g, dtype=torch.bool)
        for off, n, _ in shards:
            whole[off:off + n] = False
        sq = g[whole].square().sum()
        groups: dict = {}
        for off, n, group in shards:
            groups.setdefault(group, []).append(g[off:off + n].square().sum())
        for group, parts in groups.items():
            part = torch.stack(parts).sum()
            dist.all_reduce(part, group=group)
            sq = sq + part
        return torch.sqrt(sq)

    @torch.no_grad()
    def step(self, grad_group=None):
        """One AdamW step from the parameters' ``.grad``. With
        ``grad_group`` (a process group: the data-parallel ranks) the flat
        gradient is first summed over its ranks (each rank's gradient being
        its share of the global batch mean)."""
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        if grad_group is not None:
            dist.all_reduce(g, group=grad_group)
        p = torch.cat([p.reshape(-1) for p in self.params])
        if self.grad_clip > 0:  # optax.clip_by_global_norm, on the device
            norm = self._global_norm(g)
            g = torch.where(norm < self.grad_clip, g,
                            g / norm * self.grad_clip)
        lr = learning_rate(self.step_count, self.lr, self.warmup_steps,
                           self.cosine_decay_steps, self.x64)
        self.step_count += 1
        t = self.step_count
        bc1 = bias_correction(B1, t, self.x64)
        bc2 = bias_correction(B2, t, self.x64)
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
               warmup_steps: int = 0, cosine_decay_steps: int = 0,
               x64: bool = False) -> AdamW:
    """The JAX package's `make_adamw`, bound to ``params``: its defaults
    and its fine-tuning extensions (``grad_clip`` > 0 clips to that global
    norm first; ``warmup_steps`` > 0 warms the rate up linearly from 0;
    ``cosine_decay_steps`` > 0 decays it to 0 over the steps after the
    warmup). Horizons are optimizer steps; a negative value raises.
    ``x64`` computes the step-count scalars as optax does under
    ``jax_enable_x64`` (see the module docstring)."""
    return AdamW(params, lr=lr, weight_decay=weight_decay,
                 grad_clip=grad_clip, warmup_steps=warmup_steps,
                 cosine_decay_steps=cosine_decay_steps, x64=x64)
