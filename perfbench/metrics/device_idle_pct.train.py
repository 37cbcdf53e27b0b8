"""Share of the traced span of whole training epochs in which no kernel,
copy or set ran on the card (the union of the profiler's device
intervals), in percent."""


def read(span):
    if span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
