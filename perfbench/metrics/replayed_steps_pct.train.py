"""Share of the traced epochs' training steps that replayed captured CUDA
graphs: the program's counters ``train.steps_replayed`` over
``train.steps``, in percent. Epochs of eager steps count 0 replayed steps,
so a program that falls back to the eager step reads 0; one that keeps no
such counter reads nothing."""

from perfbench import program


def read(span):
    replayed = program.counter("train.steps_replayed")
    steps = program.counter("train.steps")
    if replayed is None or not steps:
        return None
    return 100.0 * replayed / steps
