"""Kernels #3 and #4, the attention forward and backward, in the traced
training span: the least time of every attention call's work at the real
crystals' sizes (``work.attention_work``; the forward writes its row
statistics for the backward) on the card's peaks, over their summed device
time, in percent."""

from perfbench import work

FORWARD = ("attn_fwd_kernel", "attn_fwd_rows_kernel",
           "attn_fwd_sliced_kernel")
BACKWARD = ("stats_kernel", "stats_sliced_kernel", "dq_kernel",
            "dq_sliced_kernel", "dkv_kernel", "dkv_sliced_kernel",
            "dq_rows_kernel", "dkv_rows_kernel", "reduce_kernel")


def read(span):
    took = span.seconds_of(FORWARD + BACKWARD)
    if took <= 0 or not span.crystals:
        return None
    least = 0.0
    for backward in (False, True):
        ops = byts = 0.0
        for n, _ in span.crystals:
            o, b = work.attention_work(span.cfg, n, backward, stats=True)
            ops, byts = ops + o, byts + b
        least += work.least_seconds(ops, byts)
    return 100.0 * least / took
