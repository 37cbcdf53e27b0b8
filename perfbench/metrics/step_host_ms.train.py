"""Mean host milliseconds of a training step (``train.step``), from taking
its rows to the end of its AdamW step: the host's issue of the step, which
waits for the card only where the card's queue is full
(``perfbench.program``)."""

from perfbench import program


def read(span):
    return program.step_host_ms()
