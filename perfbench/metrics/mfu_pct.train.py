"""Model FLOPs of the training steps in the traced span (forward and
backward of every real crystal at its real size, ``work.train_flops``)
over the span's length times the card's dense TF32 peak, in percent."""

from perfbench import work


def read(span):
    if span.window_s <= 0 or not span.crystals:
        return None
    flops = sum(work.train_flops(span.cfg, n, e) for n, e in span.crystals)
    return 100.0 * flops / (span.window_s * work.PEAK_FLOPS["tf32"])
