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
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

_LATER = "ROADMAP.md queue 1 item 6 (training runtime)"
B1, B2, EPS = 0.9, 0.999, 1e-8  # torch's and optax's AdamW defaults


class AdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 weight_decay: float = 1e-2):
        self.params = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("AdamW needs at least one parameter")
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("AdamW: parameters must be float32")
        self.lr, self.weight_decay = lr, weight_decay
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

    @torch.no_grad()
    def step(self):
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        p = torch.cat([p.reshape(-1) for p in self.params])
        self.step_count += 1
        t = self.step_count
        # bias corrections in f32, as optax computes 1 - decay**count
        bc1 = float(np.float32(1) - np.float32(B1) ** np.int32(t))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.int32(t))
        mu = (1 - B1) * g + self._b1_mu * self.mu.float()
        nu = (1 - B2) * (g * g) + B2 * self.nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p = p + (u + self.weight_decay * p) * (-self.lr)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        torch._foreach_copy_(self.params,
                             [x.view_as(q) for x, q in
                              zip(p.split(self._sizes), self.params)])


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
               weight_decay: float = 1e-2, *, grad_clip: float = 0.0,
               warmup_steps: int = 0, cosine_decay_steps: int = 0) -> AdamW:
    """The JAX package's `make_adamw` defaults, bound to ``params``. Its
    fine-tuning extensions (grad_clip, warmup_steps, cosine_decay_steps) are
    not in the port yet and raise."""
    for name, value in (("grad_clip", grad_clip),
                        ("warmup_steps", warmup_steps),
                        ("cosine_decay_steps", cosine_decay_steps)):
        if value:
            raise NotImplementedError(
                f"make_adamw: {name} is not in the port yet; see {_LATER}")
    return AdamW(params, lr=lr, weight_decay=weight_decay)
