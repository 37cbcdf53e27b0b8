"""The FLOP counts of ``work.py`` against ``FlopCounterMode`` over the
plain reference, at several crystal sizes, for both tasks; and the kernel
counts' basic properties."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import reference, synth, work
from perfbench.tests.bench_cells import SEED, TASKS


def _chunk(parts, sizes):
    cfg, _ = TASKS[parts]()
    rng = np.random.default_rng(SEED)
    if cfg["task"] == "edos":
        crystals = synth.edos_crystals(sizes, rng, cfg["bins"])
    else:
        crystals = synth.phdos_crystals(sizes, [4 + s % 6 for s in sizes],
                                        rng, cfg["bins"])
    chunk = reference.Chunk(crystals, cfg["task"], "cpu")
    state = reference.make_state_dict(cfg, SEED, "cpu")
    return cfg, crystals, chunk, state


def _counted(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("parts", TASKS)
@pytest.mark.parametrize("sizes", [[2], [4, 4, 17], [7, 40, 23, 7]])
def test_forward_flops(parts, sizes):
    cfg, crystals, chunk, state = _chunk(parts, sizes)
    with torch.no_grad():
        counted = _counted(lambda: reference.forward(state, cfg, chunk))
    expected = sum(work.forward_flops(cfg, s.n_nodes, s.n_edges)
                   for s in crystals)
    assert counted == expected


@pytest.mark.parametrize("parts", TASKS)
@pytest.mark.parametrize("sizes", [[3], [5, 30, 12]])
def test_train_flops(parts, sizes):
    cfg, crystals, chunk, state = _chunk(parts, sizes)
    counted = _counted(
        lambda: reference.train_steps(state, cfg, [chunk], cfg["beta"]))
    expected = sum(work.train_flops(cfg, s.n_nodes, s.n_edges)
                   for s in crystals)
    assert counted == expected


@pytest.mark.parametrize("parts", TASKS)
def test_kernel_work_grows_with_the_crystal(parts):
    cfg, _ = TASKS[parts]()
    for backward in (False, True):
        small = work.mp_work(cfg, 5, 40, backward)
        large = work.mp_work(cfg, 50, 400, backward)
        assert all(0 < a < b for a, b in zip(small, large))
        small = work.attention_work(cfg, 5, backward)
        large = work.attention_work(cfg, 50, backward)
        assert all(0 < a < b for a, b in zip(small, large))
    ops, byts = work.mp_work(cfg, 10, 120)
    assert work.least_seconds(ops, byts) == max(
        ops / work.PEAK_FLOPS["tf32"], byts / work.PEAK_BYTES_PER_S)


def test_peaks():
    assert work.PEAK_FLOPS == {"tf32": 495e12, "bf16": 989e12}
    assert work.PEAK_BYTES_PER_S == 3.35e12
