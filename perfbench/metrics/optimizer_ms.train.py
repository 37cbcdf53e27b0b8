"""Mean device milliseconds a training step spends in its phase
``step.optimizer``: the AdamW step (``train/optim.py``) to the step's end,
from the program's own record of the traced span (``perfbench.program``).
Includes the time the card waited for the host inside the phase."""

from perfbench import program


def read(span):
    return program.phase_ms("step.optimizer")
