"""Mean device milliseconds a training step spends in its phase
``step.input``: the gather of its rows on the card (``DeviceDataset.batch``),
from the program's own record of the traced span (``perfbench.program``).
Includes the time the card waited for the host inside the phase."""

from perfbench import program


def read(span):
    return program.phase_ms("step.input")
