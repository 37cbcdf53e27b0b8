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
moments are those of its shard.

Everything lives in flat buffers, in parameter order: the parameters are
views of one f32 buffer (:attr:`AdamW.flat`), their gradients views of one
f32 gradient buffer (:attr:`AdamW.grad`), the moments two more. Each
parameter's slot starts at a multiple of :data:`ALIGN` floats (256 bytes,
as ``cudaMalloc`` aligns: the kernels take aligned pointers); the gaps hold
zeros that every step leaves at zero, and the state dict and the clipping
norm read the parameters' lanes alone, packed in parameter order. A step
updates them in place with a handful of elementwise ops, so the launch count
does not grow with the number of parameters and nothing is gathered or
copied back. :meth:`AdamW.zero_grad` zeroes the gradient buffer (autograd
then accumulates into those fixed addresses); a ``.grad`` that someone else
set or cleared is copied into the buffer at the next step. So a ``.grad``
read after a step is the buffer the next step overwrites: clone what is
kept. A parameter rebound after the optimizer is built (``p.data = ...``,
``model.to``, a second optimizer on the same model) would no longer be
trained: every step first checks that each parameter still is its view,
and raises if one is not. That is what lets a
train step be captured as CUDA graphs (train/trainer.py): the step's
varying scalars, the rate and the bias corrections, reach a captured update
as a per-step table on the device (:meth:`AdamW.scalar_table`).

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
ALIGN = 64  # floats: where each parameter's slot of the flat buffers starts


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
        # offsets packed (the state dict's layout) and of the aligned slots
        self._offsets = np.cumsum([0] + self._sizes[:-1]).tolist()
        self._slots, n = [], 0
        for size in self._sizes:
            self._slots.append(n)
            n += -(-size // ALIGN) * ALIGN
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.flat = torch.zeros(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self._grads = []
        with torch.no_grad():
            for p, view, grad in zip(self.params, self._lanes(self.flat),
                                     self._lanes(self.grad)):
                view.copy_(p)
                p.data = view
                p.grad = grad
                self._grads.append(grad)
        self._ptrs = [p.data_ptr() for p in self.params]

    def _lanes(self, buf: torch.Tensor) -> list:
        """Each parameter's view of the flat buffer ``buf``, shaped like
        it."""
        return [buf[off:off + n].view_as(p) for p, off, n in
                zip(self.params, self._slots, self._sizes)]

    def _packed(self, buf: torch.Tensor) -> torch.Tensor:
        """The parameters' lanes of ``buf`` in parameter order, without
        the gaps."""
        return torch.cat([x.reshape(-1) for x in self._lanes(buf)])

    def zero_grad(self):
        """Zero the flat gradient buffer, with every ``.grad`` its view."""
        self._attach_grads()
        self.grad.zero_()

    def check_views(self) -> None:
        """Raise unless every parameter still is its view of :attr:`flat`
        (host pointers only: nothing waits for the card)."""
        for i, (p, ptr) in enumerate(zip(self.params, self._ptrs)):
            if p.data_ptr() != ptr:
                raise RuntimeError(
                    f"AdamW: parameter {i} {tuple(p.shape)} was rebound "
                    f"after the optimizer was built, so its steps would no "
                    f"longer reach it; build the optimizer after moving or "
                    f"loading the model")

    @torch.no_grad()
    def _attach_grads(self) -> None:
        """Check the parameters' views (:meth:`check_views`), then make
        each ``.grad`` its view of the flat buffer again, copying in a
        gradient set in its place (zeros for one cleared)."""
        self.check_views()
        for p, view in zip(self.params, self._grads):
            if p.grad is not view:
                if p.grad is None:
                    view.zero_()
                else:
                    view.copy_(p.grad)
                p.grad = view

    def moments(self, param: torch.nn.Parameter):
        """(mu, nu) of one parameter, shaped like it (views of the flat
        buffers)."""
        for p, off, n in zip(self.params, self._slots, self._sizes):
            if p is param:
                return (self.mu[off:off + n].view_as(p),
                        self.nu[off:off + n].view_as(p))
        raise KeyError("not a parameter of this optimizer")

    def state_dict(self) -> dict:
        """The optimizer's state: the flat moments (``mu`` bf16, ``nu``
        f32, packed in parameter order) and the step count, which alone
        sets the schedule."""
        return {"mu": self._packed(self.mu), "nu": self._packed(self.nu),
                "step_count": self.step_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy a :meth:`state_dict` into this optimizer's buffers (on
        their device); the moments must have this optimizer's size."""
        n = sum(self._sizes)
        for name in ("mu", "nu"):
            src, dst = state[name], getattr(self, name)
            if src.shape != (n,) or src.dtype != dst.dtype:
                raise ValueError(
                    f"AdamW.load_state_dict: {name} is {tuple(src.shape)} "
                    f"{src.dtype}, this optimizer's is ({n},) {dst.dtype}")
            torch._foreach_copy_(
                [x.reshape(-1) for x in self._lanes(dst)],
                list(src.to(dst.device).split(self._sizes)))
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

    def _scalars(self) -> tuple:
        """(rate, bc1, bc2) of the next step, as Python floats; the count
        advances."""
        lr = learning_rate(self.step_count, self.lr, self.warmup_steps,
                           self.cosine_decay_steps, self.x64)
        self.step_count += 1
        t = self.step_count
        return (lr, bias_correction(B1, t, self.x64),
                bias_correction(B2, t, self.x64))

    def scalar_table(self, steps: int) -> torch.Tensor:
        """The next ``steps`` steps' scalars [steps, 3] f32 on the host, as
        a captured update reads them: the rate, 1 / bc1 and 1 / bc2, each
        rounded to f32 as the card's eager ops round them (a multiply by a
        host float takes it in f32; a division by one multiplies by its
        reciprocal, formed in f64 and rounded to f32: on the H100 with
        torch 2.11, ``1 / f32(bc)`` in f32 differs in the last bit at some
        counts). The count is left as it is."""
        f32 = np.float32
        rows = []
        for c in range(self.step_count, self.step_count + steps):
            lr = learning_rate(c, self.lr, self.warmup_steps,
                               self.cosine_decay_steps, self.x64)
            rows.append([f32(lr)] + [
                f32(1.0 / bias_correction(b, c + 1, self.x64))
                for b in (B1, B2)])
        return torch.from_numpy(np.array(rows, dtype=np.float32)
                                .reshape(steps, 3))

    def _update(self, g: torch.Tensor, lr, bc1, bc2) -> None:
        """AdamW in place on the flat buffers from the flat gradient ``g``
        (clipped first with ``grad_clip``). The scalars are Python floats,
        or 0-d f32 tensors on the card holding the rate, 1 / bc1 and
        1 / bc2 (a row of :meth:`scalar_table`): the card's ``x / float``
        is ``x`` times the float's reciprocal in f32, which the tensors
        reproduce bit for bit."""
        if self.grad_clip > 0:  # optax.clip_by_global_norm, on the device
            norm = self._global_norm(self._packed(g))
            g = torch.where(norm < self.grad_clip, g,
                            g / norm * self.grad_clip)
        mu = (1 - B1) * g + self._b1_mu * self.mu.float()
        nu = (1 - B2) * (g * g) + B2 * self.nu
        if isinstance(bc1, torch.Tensor):
            u = (mu * bc1) / (torch.sqrt(nu * bc2) + EPS)
        else:
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        self.flat.add_((u + self.weight_decay * self.flat) * (-lr))
        self.mu.copy_(mu)
        self.nu.copy_(nu)

    @torch.no_grad()
    def step(self, grad_group=None):
        """One AdamW step from the parameters' ``.grad``. With
        ``grad_group`` (a process group: the data-parallel ranks) the flat
        gradient is first summed over its ranks (each rank's gradient being
        its share of the global batch mean), in a copy: ``.grad`` keeps this
        rank's share."""
        self._attach_grads()
        g = self.grad
        if grad_group is not None:
            g = g.clone()
            dist.all_reduce(g, group=grad_group)
        self._update(g, *self._scalars())

    @torch.no_grad()
    def captured_step(self, scalars: torch.Tensor) -> None:
        """The step a CUDA graph captures: the update from the flat
        gradient buffer with the scalars read from ``scalars`` [3] on the
        device (the rate, 1 / bc1, 1 / bc2), whose row the caller writes
        before each replay and whose count it advances
        (:meth:`advance`)."""
        self._update(self.grad, scalars[0], scalars[1], scalars[2])

    def advance(self) -> None:
        """Count one step taken by a replay of :meth:`captured_step`."""
        self.step_count += 1


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
