"""Device milliseconds a step that the card waited for the training loop
between steps: from each step's last event to the next step's first,
summed over each epoch of the traced span and divided by the steps
(``perfbench.program``). 0 where the loop kept the card fed."""

from perfbench import program


def read(span):
    return program.loop_idle_ms()
