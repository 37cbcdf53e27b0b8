"""Kernel #8, the transformer FFN's GEMM (csrc/ffn.cu: forward, backward
and their two helpers), in the traced training span: the least time of the
FFN's training work at the real crystals' rows on the card's TF32 peak,
over #8's summed device time, in percent. The program without #8 reads
nothing here.

The work, counted here from the configuration alone: each crystal's
energy tokens pass the FFN ``5 t_layers`` times (the cross stack over its
``bins`` rows, the two heads' stacks each over ``bins`` rows of the
crystal's two copies), at 48 h^2 operations a row forward and backward
(fc1 and fc2, 8 h^2 multiply-adds each way, twice that for the two
gradients). Bytes: each row's activations read or written once (forward:
x in, H and y out; backward: x, H and dY in, dX out: 13 h floats), and
each step's FFN calls (3 t_layers) read the weights twice and write
their gradients once. 3xTF32 makes three products of each, so the share
cannot pass a third."""

from perfbench import work

KERNELS = ("ffn_gemm_kernel", "ffn_split_kernel", "ffn_reduce_kernel")


def read(span):
    took = span.seconds_of(KERNELS)
    if took <= 0 or not span.crystals:
        return None
    cfg = span.cfg
    h, t = cfg["hidden"], cfg["t_layers"]
    rows = len(span.crystals) * cfg["bins"] * 5 * t
    ops = 48.0 * h * h * rows
    params = 8 * h * h + 5 * h
    floats = 13.0 * h * rows + span.units * 3 * t * 3 * params
    least = work.least_seconds(ops, work.F32 * floats)
    return 100.0 * least / took
