"""The harness: cells, mixes, limits and metrics found by name; the shape
of the result line; the names and units of ``BENCHMARK.json``; small runs
on the CPU that come out correct, and that come out not correct with the
timed path broken underneath or with the control in the program's place.
The card test (marker ``cuda``) runs each cell for a few seconds and
decides inside the test whether a card is there."""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run as bench_run
from perfbench.drivers import DRIVERS
from perfbench.tests.bench_cells import SEED, small_cell

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_only_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", []):  # cells that report what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        reported = bench_run.load_cell(w["name"])
        assert any(m["name"] != "setup_s" for m in reported["end_to_end"])
        assert reported["per_layer"]
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert json.loads((CHECKOUT / c["file"]).read_text())["reduced"] \
            == c["reduced"]


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A cell, a traffic mix, its limits and a per-layer metric that a later
    change adds as new files only."""
    shutil.copytree(CHECKOUT / "perfbench", tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "edos.train_small",
                               "config": "edos_h256",
                               "traffic": "edos_train_small", "chips": 1,
                               "why": "a small corpus"})
    bench["per_layer"].append({"name": "device_busy_s.small", "unit": "s",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_crystals_per_s",
                               "workloads": ["edos.train_small"]})
    bench["end_to_end"][0]["workloads"].append("edos.train_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = tmp_path / "perfbench"
    mix = json.loads((root / "traffic" / "edos_train_b64.json").read_text())
    mix["crystals"] = 512
    (root / "traffic" / "edos_train_small.json").write_text(json.dumps(mix))
    (root / "limits" / "edos.train_small.json").write_text(
        json.dumps({"loss_gap": 1e-3, "grad_gap": 1e-3,
                    "change_gap_median": 1e-3}))
    (root / "metrics" / "device_busy_s.small.py").write_text(
        "def read(span):\n    return span.busy_s\n")
    cell = bench_run.load_cell("edos.train_small", root=root)
    assert cell["mix"]["crystals"] == 512
    assert [m["name"] for m in cell["per_layer"]] == ["device_busy_s.small"]
    assert [m["name"] for m in cell["end_to_end"]] == [
        "train_crystals_per_s", "setup_s"]
    read = bench_run.reader("device_busy_s.small", root=root)
    assert read(type("S", (), {"busy_s": 1.5})()) == 1.5


def _run(name, trace=False, cell=None):
    cell = cell or small_cell(name)
    return bench_run.run(name, SEED, 0.5, trace, device="cpu", cell=cell)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct_and_its_line_has_the_contract_keys(name,
                                                                 trace):
    line = _run(name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = small_cell(name)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    # the CPU run reads no kernel of the card: the rooflines stay silent
    silent = {m["name"] for m in wanted if "roofline" in m["name"]}
    assert set(line["metrics"]) == {m["name"] for m in wanted} - (
        silent if trace else set())
    assert all(v["value"] > 0 or "idle" in k
               for k, v in line["metrics"].items())
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    json.dumps(line, allow_nan=False)


def _train_faults(monkeypatch, fault):
    from dostransformer_tpu_torch.train import device_dataset, optim, trainer

    batch = device_dataset.DeviceDataset.batch
    if fault == "state_unchanged":
        monkeypatch.setattr(optim.AdamW, "step",
                            lambda self, grad_group=None: None)
    elif fault == "half_batch":
        def half(self, idx):
            b = batch(self, idx)
            mask = b.graph_mask.clone()
            mask[len(mask) // 2:] = 0
            return dataclasses.replace(b, graph_mask=mask)

        monkeypatch.setattr(device_dataset.DeviceDataset, "batch", half)
    elif fault == "dummies_counted":  # the mean over the padded batch
        def counted(self, idx):
            b = batch(self, idx)
            return dataclasses.replace(
                b, graph_mask=torch.ones_like(b.graph_mask))

        monkeypatch.setattr(device_dataset.DeviceDataset, "batch", counted)
    elif fault == "answer_altered":
        loss = trainer.dos_loss

        def altered(*args, **kwargs):
            value, parts = loss(*args, **kwargs)
            return value * 1.001, parts

        monkeypatch.setattr(trainer, "dos_loss", altered)


FAULTS = ["state_unchanged", "half_batch", "dummies_counted",
          "answer_altered"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """The run with the timed path broken underneath (the card's look
    skipped: a CPU run). The exchange between chips, the contract's fourth
    fault, has no place in a one-card cell; dummy graphs counted in the
    loss show only on the partial check batch."""
    cell = small_cell(name)
    _train_faults(monkeypatch, fault)
    line = _run(name, cell=cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The control, the reference in TF32 in the program's place, fails
    one of the cell's numbers (at the small size; on the card the cell's
    own size was read by ``perfbench.control``)."""
    cell = small_cell(name)
    driver = DRIVERS[cell["mix"]["kind"]](cell["cfg"], cell["mix"], SEED,
                                          "cpu")
    driver.setup()
    driver.finish()
    control = driver.control()
    assert any(v > cell["limits"][k] for k, v in control.items()), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, tmp_path):
    """One short run of the cell on the card, as the driver starts it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", name,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=CHECKOUT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
