"""The training loop's metrics, read from the program's own record
(``perfbench.program``), in a small traced run on the CPU: the phases and
the loop's idle tile the epoch, the useful share of atom rows is the one
the corpus and the port's ``bucket_size`` give, the program's spans leave
the profile the other metrics read as it was, and a program without the
tracing module reads nothing."""

from __future__ import annotations

import math
import sys

import pytest

from perfbench import run as bench_run
from perfbench.drivers import DRIVERS
from perfbench.tests.bench_cells import SEED, small_cell

CELL = "edos.train"
PHASES = ("input", "forward", "backward", "optimizer")
MINE = ["input_ms.train", "forward_ms.train", "backward_ms.train",
        "optimizer_ms.train", "loop_idle_ms.train", "step_host_ms.train",
        "atom_rows_useful_pct.train"]
SPANS = {"train.epoch", "train.step", "step.input", "step.forward",
         "step.backward", "step.optimizer"}


@pytest.fixture(scope="module")
def traced():
    """(driver, traced span, every per-layer metric of the cell) of one
    small traced run, read as ``run.py`` reads them."""
    cell = small_cell(CELL)
    driver = DRIVERS[cell["mix"]["kind"]](cell["cfg"], cell["mix"], SEED,
                                          "cpu")
    driver.setup()
    span = driver.span()
    metrics = {m["name"]: bench_run.reader(m["name"])(span)
               for m in cell["per_layer"]}
    return driver, span, metrics


def test_phases_and_idle_tile_the_epoch(traced):
    from dostransformer_tpu_torch import tracing

    driver, span, metrics = traced
    rec = tracing.record()
    (epoch,) = [s for s in rec.spans if s.name == "train.epoch"]
    a, b = rec.device_interval(epoch)
    steps = rec.counters["train.steps"]
    assert steps == span.units == driver.steps
    tiled = steps * sum(metrics[f"{p}_ms.train"] for p in PHASES)
    tiled += steps * metrics["loop_idle_ms.train"]
    assert tiled == pytest.approx(b - a, rel=0.05)
    assert all(metrics[f"{p}_ms.train"] > 0 for p in PHASES)
    assert 0 < metrics["step_host_ms.train"] * steps <= b - a


def test_useful_atom_rows_are_the_corpus_over_its_buckets(traced):
    from dostransformer_tpu_torch.data.graph import bucket_size

    driver, _, metrics = traced
    batch = driver.mix["batch_size"]
    groups = {}
    for s in driver.corpus:
        groups.setdefault(bucket_size(s.n_nodes), []).append(s.n_nodes)
    rows = sum(sum(g) for g in groups.values())
    slots = sum(a * math.ceil(len(g) / batch) * batch
                for a, g in groups.items())
    assert metrics["atom_rows_useful_pct.train"] == pytest.approx(
        100.0 * rows / slots, rel=1e-12)
    assert metrics["atom_rows_useful_pct.train"] < 100.0


def test_program_spans_stay_out_of_the_profile_the_metrics_read(traced):
    _, span, _ = traced
    assert not set(span.kernel_s) & SPANS
    assert not {n for n, _ in span.breakdown()["device_ops"]} & SPANS


def test_a_program_without_tracing_reads_nothing(traced, monkeypatch):
    """The metrics' files laid over a program that lacks the module (a
    version of the port from before it) leave the metrics out."""
    import dostransformer_tpu_torch

    _, span, _ = traced
    monkeypatch.delattr(dostransformer_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "dostransformer_tpu_torch.tracing",
                        None)
    assert all(bench_run.reader(name)(span) is None for name in MINE)
