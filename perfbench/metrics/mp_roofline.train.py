"""Kernels #1 and #2, the fused message passing forward and backward, in
the traced training span: the least time of their work at the real
crystals' sizes (each processor's call of each; ``work.mp_work``) on the
card's peaks, over their summed device time, in percent."""

from perfbench import work

FORWARD = ("edge_kernel", "edge_tc_kernel", "agg_kernel")
BACKWARD = ("edge_bwd_kernel", "edge_bwd_tc_kernel", "gw1_kernel",
            "gw1_tc_kernel", "tail_kernel")


def read(span):
    took = span.seconds_of(FORWARD + BACKWARD)
    if took <= 0 or not span.crystals:
        return None
    least = 0.0
    for backward in (False, True):
        ops = byts = 0.0
        for n, e in span.crystals:
            o, b = work.mp_work(span.cfg, n, e, backward)
            ops, byts = ops + o, byts + b
        layers = span.cfg["layers"]
        least += work.least_seconds(layers * ops, layers * byts)
    return 100.0 * least / took
