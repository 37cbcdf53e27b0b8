"""Plain PyTorch reference of the eDOS and phDOS DOSTransformer, its loss
and AdamW: what the benchmark holds the port's timed path against.

It imports torch and numpy only: neither ``jax``, nor the JAX package, nor
anything of the port. The benchmark makes the weights here
(:func:`make_state_dict`, in the reference's state_dict naming, which the
port loads with ``load_reference_state_dict``) and the inputs in
``synth.py``, and hands the same to both sides; everything the port derives
from them (padding, buckets, projections, edge geometry, optimizer state)
is worked out again here.

The model is the published DOSTransformer (HeewoongNoh/DOSTransformer,
NeurIPS 2023: ``main_eDOS.py``, ``main_phDOS.py`` and their
``embedder*/DOSTransformer*.py``), written per crystal and unpadded:

  * message passing on the disjoint union of a chunk's crystals (PyG's
    batch layout): encoders; ``layers`` processors, each an EdgeModel
    ``MLP([x_src, x_dst, e])`` (Linear, LayerNorm, PReLU, Linear) and a
    NodeModel ``MLP([x, agg])`` with agg the scatter-sum (eDOS) or
    scatter-mean (phDOS) of the new edge features onto their receivers,
    each with its residual;
  * the readout: the graph sum of the node embeddings (eDOS: beside the
    encoded global features) through one Linear;
  * energy tokens (a learned table of ``bins`` rows) through three pre-LN
    transformer stacks (one LayerNorm on q, k and v; projection-free
    single-head attention; a 4x ReLU FFN; a final LayerNorm; the keys and
    values the stack's fixed input): cross-attention over the crystal's
    own atoms, then the global and the prompt-token (crystal system) heads
    through the self-attention and the source cross-attention stacks and
    one shared output Linear. Each crystal attends over its own atoms only,
    which is the port's ``padding="mask"``;
  * eDOS serving clamps the system head at 0;
  * the loss: per-crystal RMSE over the bins of each head against the
    targets (eDOS clamps them at 0), averaged over the crystals,
    ``rmse_global + beta * rmse_system``;
  * AdamW at the port's ``make_adamw`` defaults, which follow the JAX
    package's optax step: lr 1e-4, weight decay 1e-2, b1 0.9, b2 0.999,
    eps 1e-8, the first moment stored in bfloat16 and decayed by
    bf16(0.9), the second in f32, f32 bias corrections.

Departures from the published code, none of which changes the function:
the EdgeModel's first Linear is applied as three column slices of its
weight, the two node parts at node count and then gathered (the same map
as concatenating first); the NodeModel's Linear likewise takes its two
inputs as two slices; the reference's dead parameters (attention in/out
projections, ``node_mlp_1``) are not made; phDOS runs in f32 where the
published code runs f64 (``main_phDOS.py:14-16``).

Precision: f32 with TF32 off (:func:`strict_f32`). With ``tf32=True`` every
product rounds its operands to TF32 first (10-bit mantissa, f32
accumulation), on any device: the control, the nearest precision below the
configuration's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
LEAKY_SLOPE = 0.01
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the seeded weights' spread around torch's defaults, so that LayerNorm
# scales and biases, the PReLU slopes and the FFN biases are not the
# identity or zero (a path that dropped one would still agree otherwise);
# the output bias is drawn around 1 (see param_specs)
LN_SPREAD, PRELU_SPREAD, FFN_BIAS_SPREAD = 0.1, 0.05, 0.02


def strict_f32() -> None:
    """f32 products in f32 on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (round to nearest on the 10-bit mantissa)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast product's gradient summed back to its operand's shape."""
    while t.dim() > len(shape):
        t = t.sum(0)
    return t


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, and in the backward
    the incoming gradient too: every product of the forward and the
    backward takes TF32 operands and accumulates in f32."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _tf32(a), _tf32(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = a.shape, b.shape
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _tf32(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(torch.matmul(rg, rb.transpose(-1, -2)), ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            gb = _sum_to(torch.matmul(ra.transpose(-1, -2), rg), ctx.shapes[1])
        return ga, gb


class Ops:
    """The products of the reference, in f32 or, with ``tf32``, with their
    operands rounded to TF32 (forward and backward)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def linear(self, x, w, b=None):
        if not self.tf32:
            return F.linear(x, w, b)
        y = _TF32Matmul.apply(x, w.t())
        return y if b is None else y + b

    def matmul(self, a, b):
        if not self.tf32:
            return torch.matmul(a, b)
        return _TF32Matmul.apply(a, b)


# ---------------------------------------------------------------- weights


def param_specs(cfg: dict) -> Dict[str, Tuple[tuple, str, float]]:
    """name -> (shape, draw, scale) of every parameter, in the reference's
    state_dict naming. Draws: "u" uniform(-scale, scale) (torch's Linear
    bound, or xavier's for the FFN), "n" N(0, 1) (embeddings), "one"
    1 + uniform(-scale, scale) (LayerNorm scales), "prelu" 0.25 +
    uniform(-scale, scale)."""
    h, task = cfg["hidden"], cfg["task"]
    specs: Dict[str, Tuple[tuple, str, float]] = {}

    def lin(name, fan_in, fan_out, xavier=False):
        if xavier:
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            specs[f"{name}.weight"] = ((fan_out, fan_in), "u", bound)
            specs[f"{name}.bias"] = ((fan_out,), "u", FFN_BIAS_SPREAD)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            specs[f"{name}.weight"] = ((fan_out, fan_in), "u", bound)
            specs[f"{name}.bias"] = ((fan_out,), "u", bound)

    def ln(name, d):
        specs[f"{name}.weight"] = ((d,), "one", LN_SPREAD)
        specs[f"{name}.bias"] = ((d,), "u", LN_SPREAD)

    def mlp2(name, fan_in):
        lin(f"{name}.0", fan_in, h)
        specs[f"{name}.1.weight"] = ((1,), "prelu", PRELU_SPREAD)
        lin(f"{name}.2", h, h)

    def block(name, fan_in, mid, out):
        lin(f"{name}.0", fan_in, mid)
        ln(f"{name}.1", mid)
        specs[f"{name}.2.weight"] = ((1,), "prelu", PRELU_SPREAD)
        lin(f"{name}.3", mid, out)

    specs["embeddings.weight"] = ((cfg["bins"], h), "n", 1.0)
    specs[f"{prompt_name(task)}.weight"] = ((cfg["prompts"], h // 2), "n",
                                            1.0)
    mlp2("GN_encoder.node_encoder", cfg["node_in"])
    mlp2("GN_encoder.edge_encoder", cfg["edge_in"])
    if task == "edos":
        mlp2("GN_encoder.global_encoder", cfg["glob_in"])
    for i in range(cfg["layers"]):
        block(f"stacked_processor.{i}.edge_model.edge_mlp", 3 * h, 2 * h, h)
        block(f"stacked_processor.{i}.node_model.node_mlp_2", 2 * h, 2 * h,
              h)
    lin("GN_decoder.mlp.0", 2 * h if task == "edos" else h, h)
    for stack in STACKS:
        for j in range(cfg["t_layers"]):
            lin(f"{stack}.layers.{j}.fc1", h, 4 * h, xavier=True)
            lin(f"{stack}.layers.{j}.fc2", 4 * h, h, xavier=True)
            ln(f"{stack}.layers.{j}.layer_norms.0", h)
            ln(f"{stack}.layers.{j}.layer_norms.1", h)
        ln(f"{stack}.layer_norm", h)
    lin("fc", 2 * h, h)
    lin("fc_prompt", 2 * h + h // 2, h)
    lin("out_layer", h, 1)
    # around 1, so that the served spectra are positive as real ones are,
    # and eDOS's clamp at 0 leaves them whole
    specs["out_layer.bias"] = ((1,), "one", 1.0 / math.sqrt(h))
    return specs


STACKS = ("transformer", "transformer_self", "transformer_source")


def prompt_name(task: str) -> str:
    """The prompt table's name, spelt per task as the published code spells
    it."""
    return "promt_token" if task == "edos" else "prompt_token"


def make_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``seed`` on ``device`` in two calls of
    one generator there (one uniform, one normal draw), then cut and
    scaled: f32 tensors in the reference's naming."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for s, d, _ in specs.values() if d != "n")
    n_n = sum(math.prod(s) for s, d, _ in specs.values() if d == "n")
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, (shape, draw, scale) in specs.items():
        k = math.prod(shape)
        if draw == "n":
            t = nrm[inn:inn + k]
            inn += k
        else:
            t = uni[iu:iu + k] * scale
            iu += k
            if draw == "one":
                t = t + 1.0
            elif draw == "prelu":
                t = t + 0.25
        out[name] = t.reshape(shape).clone()
    return out


# ---------------------------------------------------------------- inputs


class Chunk:
    """A list of crystals as the reference takes them, on ``device``: the
    disjoint union of their graphs (nodes and edges concatenated, edge
    indices offset), and the crystals grouped by atom count for the
    attention over each crystal's own atoms."""

    def __init__(self, samples: Sequence, task: str, device):
        self.task = task
        self.count = len(samples)
        n = np.array([s.x.shape[0] for s in samples], np.int64)
        offsets = np.concatenate([[0], np.cumsum(n)[:-1]])
        cat = lambda arrs: torch.from_numpy(np.concatenate(arrs)).to(device)
        self.nodes = cat([s.x for s in samples]).float()
        self.senders = cat([s.edge_index[0] + o
                            for s, o in zip(samples, offsets)]).long()
        self.receivers = cat([s.edge_index[1] + o
                              for s, o in zip(samples, offsets)]).long()
        self.graph = torch.from_numpy(np.repeat(np.arange(len(n)), n)).to(
            device)
        if task == "edos":
            self.edge_attr = cat([s.edge_attr for s in samples]).float()
            self.glob = cat([np.asarray(s.glob, np.float32)[None]
                             for s in samples])
        else:
            self.edge_vec = cat([s.edge_vec for s in samples]).float()
        self.system = torch.tensor([s.system for s in samples],
                                   device=device, dtype=torch.long)
        self.y = cat([np.asarray(s.y, np.float32)[None] for s in samples])
        # crystals of one atom count: (their positions, their node rows
        # [count, n])
        self.groups: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for size in np.unique(n):
            idx = np.nonzero(n == size)[0]
            rows = offsets[idx][:, None] + np.arange(size)[None]
            self.groups.append((torch.from_numpy(idx).to(device),
                                torch.from_numpy(rows).to(device)))


# ---------------------------------------------------------------- model


def _prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _mlp2(ops, p, name, x):
    x = ops.linear(x, p[f"{name}.0.weight"], p[f"{name}.0.bias"])
    x = _prelu(x, p[f"{name}.1.weight"])
    return ops.linear(x, p[f"{name}.2.weight"], p[f"{name}.2.bias"])


def _block_tail(ops, p, name, hid):
    """LayerNorm, PReLU, second Linear of an MLP block."""
    hid = _prelu(_ln(hid, p, f"{name}.1"), p[f"{name}.2.weight"])
    return ops.linear(hid, p[f"{name}.3.weight"], p[f"{name}.3.bias"])


def edge_geometry(edge_vec: torch.Tensor, r_max: float) -> torch.Tensor:
    """phDOS edge features: e3nn's spherical harmonics l <= 1
    ('component', normalised input) times the smooth cutoff of |v| /
    r_max: [E, 3] -> [E, 4]; a zero vector gives [1, 0, 0, 0]."""
    r = torch.linalg.vector_norm(edge_vec, dim=-1, keepdim=True)
    sh = torch.cat([torch.ones_like(r),
                    math.sqrt(3.0) * edge_vec / torch.clamp(r, min=1e-12)],
                   -1)
    u = 2.0 * (r / r_max - 1.0)
    cut = torch.where(u > 0, 0.0,
                      torch.where(u < -1, 1.0,
                                  (1.0 - torch.cos(math.pi * u)) / 2.0))
    return cut * sh


def message_passing(ops, p, cfg, c: Chunk):
    """Encoders and processors on the chunk's union graph: the node
    embeddings [N, h] and, for eDOS, the encoded global features [G, h]."""
    h, mean = cfg["hidden"], cfg["task"] == "phdos"
    x = _mlp2(ops, p, "GN_encoder.node_encoder", c.nodes)
    edge_in = (c.edge_attr if not mean
               else edge_geometry(c.edge_vec, cfg["r_max"]))
    e = _mlp2(ops, p, "GN_encoder.edge_encoder", edge_in)
    u = (_mlp2(ops, p, "GN_encoder.global_encoder", c.glob)
         if not mean else None)
    n = x.shape[0]
    if mean:
        count = torch.zeros(n, device=x.device, dtype=x.dtype).index_add_(
            0, c.receivers, torch.ones_like(c.receivers, dtype=x.dtype))
        count = torch.clamp(count, min=1.0)[:, None]
    for i in range(cfg["layers"]):
        em = f"stacked_processor.{i}.edge_model.edge_mlp"
        w0, b0 = p[f"{em}.0.weight"], p[f"{em}.0.bias"]
        hid = (ops.linear(x, w0[:, :h])[c.senders]
               + ops.linear(x, w0[:, h:2 * h])[c.receivers]
               + ops.linear(e, w0[:, 2 * h:], b0))
        e_out = _block_tail(ops, p, em, hid)
        agg = torch.zeros(n, h, device=x.device,
                          dtype=x.dtype).index_add_(0, c.receivers, e_out)
        if mean:
            agg = agg / count
        nm = f"stacked_processor.{i}.node_model.node_mlp_2"
        w0, b0 = p[f"{nm}.0.weight"], p[f"{nm}.0.bias"]
        hid = ops.linear(x, w0[:, :h]) + ops.linear(agg, w0[:, h:], b0)
        x = x + _block_tail(ops, p, nm, hid)
        e = e + e_out
    return x, u


def _stack(ops, p, name, cfg, x, keys):
    """A pre-LN transformer stack: queries x [G, L, h] over the fixed keys
    = values ``keys`` [G, Lk, h] (None: the stack's own input)."""
    keys = x if keys is None else keys
    for j in range(cfg["t_layers"]):
        pre = f"{name}.layers.{j}"
        q = _ln(x, p, f"{pre}.layer_norms.0")
        k = _ln(keys, p, f"{pre}.layer_norms.0")
        scores = ops.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        x = x + ops.matmul(torch.softmax(scores, dim=-1), k)
        f = torch.relu(ops.linear(_ln(x, p, f"{pre}.layer_norms.1"),
                                  p[f"{pre}.fc1.weight"],
                                  p[f"{pre}.fc1.bias"]))
        x = x + ops.linear(f, p[f"{pre}.fc2.weight"], p[f"{pre}.fc2.bias"])
    return _ln(x, p, f"{name}.layer_norm")


def _per_crystal(ops, p, name, cfg, queries, x, c: Chunk):
    """The stack ``name`` of each crystal's queries [G, L, h] over that
    crystal's own atoms, a group of equal atom counts at a time."""
    out = torch.empty_like(queries)
    for idx, rows in c.groups:
        out[idx] = _stack(ops, p, name, cfg, queries[idx], x[rows])
    return out


def forward(p: Dict[str, torch.Tensor], cfg: dict, c: Chunk,
            tf32: bool = False):
    """(dos_global, dos_system), each [G, bins], of the chunk's crystals."""
    ops = Ops(tf32)
    x, u = message_passing(ops, p, cfg, c)
    h, bins, g = cfg["hidden"], cfg["bins"], c.count
    pooled = torch.zeros(g, h, device=x.device, dtype=x.dtype).index_add_(
        0, c.graph, x)
    read_in = torch.cat([u, pooled], -1) if u is not None else pooled
    graph = ops.linear(read_in, p["GN_decoder.mlp.0.weight"],
                       p["GN_decoder.mlp.0.bias"])
    energies = p["embeddings.weight"].expand(g, bins, h)
    energies = _per_crystal(ops, p, "transformer", cfg, energies, x, c)
    graph = graph[:, None, :].expand(g, bins, h)
    leaky = lambda t: F.leaky_relu(t, LEAKY_SLOPE)
    dos_g = leaky(ops.linear(torch.cat([energies, graph], -1),
                             p["fc.weight"], p["fc.bias"]))
    prompt = p[f"{prompt_name(cfg['task'])}.weight"][c.system]
    prompt = prompt[:, None, :].expand(g, bins, prompt.shape[-1])
    dos_s = leaky(ops.linear(torch.cat([energies, graph, prompt], -1),
                             p["fc_prompt.weight"], p["fc_prompt.bias"]))
    both = _stack(ops, p, "transformer_self", cfg,
                  torch.cat([dos_g, dos_s], 0), None)
    c2 = _Twice(c)
    both = _per_crystal(ops, p, "transformer_source", cfg, both, x, c2)
    both = ops.linear(both, p["out_layer.weight"], p["out_layer.bias"])[..., 0]
    return both[:g], both[g:]


class _Twice:
    """A chunk's groups for the two heads stacked as 2G rows."""

    def __init__(self, c: Chunk):
        self.groups = [(torch.cat([idx, idx + c.count]),
                        torch.cat([rows, rows])) for idx, rows in c.groups]


def loss(p, cfg, c: Chunk, beta: float = 1.0, tf32: bool = False):
    """rmse_global + beta * rmse_system, averaged over the chunk's
    crystals (eDOS targets clamped at 0)."""
    dos_g, dos_s = forward(p, cfg, c, tf32)
    y = torch.clamp(c.y, min=0.0) if cfg["task"] == "edos" else c.y
    rmse = lambda pred: torch.sqrt(((y - pred) ** 2).mean(-1)).mean()
    return rmse(dos_g) + beta * rmse(dos_s)


# ---------------------------------------------------------------- AdamW


class AdamW:
    """The port's default AdamW (see the module docstring), leaf by leaf."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 1e-2):
        self.lr, self.wd = lr, weight_decay
        self.b1_mu = float(torch.tensor(B1, dtype=torch.bfloat16))
        self.mu = {k: torch.zeros_like(v, dtype=torch.bfloat16)
                   for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** np.int32(self.count))
        bc2 = float(f32(1) - f32(B2) ** np.int32(self.count))
        for k, p in params.items():
            g = grads[k]
            mu = (1 - B1) * g + self.b1_mu * self.mu[k].float()
            nu = (1 - B2) * (g * g) + B2 * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            p.copy_(p + (u + self.wd * p) * (-self.lr))
            self.mu[k].copy_(mu)
            self.nu[k].copy_(nu)


def train_steps(state: Dict[str, torch.Tensor], cfg: dict,
                chunks: Sequence[Chunk], beta: float = 1.0,
                tf32: bool = False):
    """The reference's training from ``state`` over one chunk a step.
    Returns (loss of each step, the first step's gradient by leaf, the
    parameters after the last step by leaf)."""
    params = {k: v.detach().clone() for k, v in state.items()}
    opt = AdamW(params)
    losses, first = [], None
    for c in chunks:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = loss(leaves, cfg, c, beta, tf32)
        grads = torch.autograd.grad(value, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        for v in params.values():
            v.requires_grad_(False)
        if first is None:
            first = grads
        losses.append(value.item())
        opt.step(params, grads)
    return losses, first, params
