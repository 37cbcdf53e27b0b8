"""Mean device milliseconds a training step spends in its phase
``step.forward``: ``zero_grad``, the model's forward and the loss, from the
program's own record of the traced span (``perfbench.program``). Includes
the time the card waited for the host inside the phase."""

from perfbench import program


def read(span):
    return program.phase_ms("step.forward")
