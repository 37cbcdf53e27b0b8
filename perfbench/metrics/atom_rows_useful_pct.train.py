"""Share of the atom rows the traced epochs computed that belong to real
crystals: the program's counters ``train.atom_rows`` (the real crystals'
node rows) over ``train.atom_slots`` (each step's atom bucket times every
graph slot, the dummy graphs that fill a bucket's last batch included), in
percent. Set by the corpus's sizes and the bucketing and padding rules."""

from perfbench import program


def read(span):
    rows = program.counter("train.atom_rows")
    slots = program.counter("train.atom_slots")
    if not rows or not slots:
        return None
    return 100.0 * rows / slots
