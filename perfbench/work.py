"""The work of a crystal and of each kernel, counted from real sizes, and
the card's peaks.

Model FLOPs count the products of the plain reference (``reference.py``):
every ``linear`` and attention ``matmul`` at 2 m k n, for a crystal of n
nodes (its atoms, and for eDOS the prompt row) and e edges; a training step
adds the backward's products, the gradient of each weight and of each
input that needs one (every input but the raw features the encoders
read). ``tests/test_work.py`` holds these counts against
``torch.utils.flop_counter.FlopCounterMode`` over the reference.

Kernel work counts what the computation needs at the real sizes, never the
padding: each input byte read once and each output byte written once, and
the operations of its products plus the elementwise work per feature that
``chip_smoke.py``'s ``mp_work`` counts. A roofline share is then the least
time of that work on the card's peaks over the kernels' measured time.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense (NVIDIA's data sheet, at the 700 W limit)
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def _dims(cfg: dict):
    return cfg["hidden"], cfg["bins"], cfg["t_layers"], cfg["layers"]


def forward_flops(cfg: dict, n: int, e: int) -> float:
    """Products of one crystal's forward (n nodes, e edges)."""
    h, bins, t, layers = _dims(cfg)
    fx, fe = cfg["node_in"], cfg["edge_in"]
    f = 2 * n * (fx * h + h * h) + 2 * e * (fe * h + h * h)  # encoders
    if cfg["task"] == "edos":
        f += 2 * (cfg["glob_in"] * h + h * h) + 2 * 2 * h * h  # glob, readout
    else:
        f += 2 * h * h  # readout
    f += layers * (20 * n * h * h + 8 * e * h * h)  # processors
    cross = 4 * bins * n * h + 16 * bins * h * h    # a layer over the atoms
    self_ = 4 * bins * bins * h + 16 * bins * h * h
    f += t * cross                                  # transformer
    f += 2 * t * (self_ + cross)                    # the two heads
    f += 2 * bins * (2 * h) * h + 2 * bins * (2 * h + h // 2) * h  # fc, prompt
    f += 2 * 2 * bins * h                           # out_layer
    return float(f)


def train_flops(cfg: dict, n: int, e: int) -> float:
    """Products of one crystal's forward and backward: the backward doubles
    every product but the encoders' first, whose inputs are data."""
    h = cfg["hidden"]
    data = 2 * n * cfg["node_in"] * h + 2 * e * cfg["edge_in"] * h
    if cfg["task"] == "edos":
        data += 2 * cfg["glob_in"] * h
    return 3 * forward_flops(cfg, n, e) - data


def mp_work(cfg: dict, n: int, e: int, backward: bool = False):
    """(ops, bytes) of one call of the fused message-passing kernel (#1,
    or #2 with ``backward``) for one crystal: the [2h] x [2h, h] product
    of each real edge (twice in the backward) and ~12 (~30) elementwise
    operations per feature for the gathers, LayerNorm and PReLU."""
    h = cfg["hidden"]
    m = 2 * h
    node_in = 2 * n * m          # src_proj, dst_proj
    params = 2 * m + 1 + m * h   # LayerNorm, PReLU slope, W1
    if not backward:
        ops = e * (2 * m * h + 12 * m + 2 * h)
        read = node_in + e * m + 3 * e + params + h
        write = e * h + n * h    # e_out, agg
    else:
        ops = e * (4 * m * h + 30 * m)
        read = node_in + e * m + 3 * e + params + e * h + n * h
        write = node_in + e * m + params + h
    return float(ops), float(F32 * (read + write))


def attention_calls(cfg: dict, n: int):
    """(queries, keys) of every attention call of one crystal's forward."""
    bins, t = cfg["bins"], cfg["t_layers"]
    return ([(bins, n)] * t + [(bins, bins)] * (2 * t)
            + [(bins, n)] * (2 * t))


def attention_work(cfg: dict, n: int, backward: bool = False,
                   stats: bool = False):
    """(ops, bytes) of one crystal's attention calls (#3, or #4 with
    ``backward``), keys and values one tensor as the stacks pass them: the
    forward's two products (the backward's four and the recomputed
    scores), q and k read, the key bias, the output (and with ``stats``
    the row statistics) written; the backward reads q, k, the incoming
    gradient and the statistics and writes dq, dk and dv."""
    d = cfg["hidden"]
    ops = byts = 0.0
    for lq, lk in attention_calls(cfg, n):
        if not backward:
            ops += 4 * lq * lk * d
            byts += F32 * (2 * lq * d + lk * d + lk
                           + (2 * lq if stats else 0))
        else:
            ops += 10 * lq * lk * d
            byts += F32 * (2 * lq * d + lk * d + lk + 2 * lq
                           + lq * d + 2 * lk * d)
    return ops, byts


def least_seconds(ops: float, byts: float, dtype: str = "tf32") -> float:
    """The least time of (ops, bytes) on the card: the larger of the two
    bounds."""
    return max(ops / PEAK_FLOPS[dtype], byts / PEAK_BYTES_PER_S)
