"""The plain reference against the port's CPU path, at a small size with
seeded weights, for both tasks; and the import rule for every module of
the benchmark."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import reference, synth
from perfbench.drivers import _build_model
from perfbench.tests.bench_cells import SEED, TASKS

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dostransformer_tpu"}


def _port_and_reference(parts):
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.models.import_torch import (
        load_reference_state_dict,
    )

    cfg, mix = TASKS[parts]()
    rng = np.random.default_rng(SEED)
    crystals = synth.crystals(cfg["task"], mix, 12, rng, cfg["bins"])
    state = reference.make_state_dict(cfg, SEED, "cpu")
    model = _build_model(cfg, crystals[0], "cpu")
    load_reference_state_dict(model, state)
    return cfg, crystals, state, model, collate(crystals)


@pytest.mark.parametrize("parts", TASKS)
def test_reference_state_dict_is_the_ports(parts):
    cfg, _, state, model, _ = _port_and_reference(parts)
    assert list(state) and set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("parts", TASKS)
def test_forward_matches_port(parts):
    cfg, crystals, state, model, batch = _port_and_reference(parts)
    with torch.no_grad():
        port_g, _, port_s = model.eval()(batch)
        ref_g, ref_s = reference.forward(
            state, cfg, reference.Chunk(crystals, cfg["task"], "cpu"))
    for port, ref in ((port_g, ref_g), (port_s, ref_s)):
        err = (port - ref).abs().max().item()
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("parts", TASKS)
def test_training_matches_port(parts):
    """Three steps of the port's Trainer against the reference's: losses,
    the first gradient and the parameters after the steps."""
    from dostransformer_tpu_torch.train.trainer import Trainer

    from dostransformer_tpu_torch.data.graph import collate

    cfg, crystals, state, model, _ = _port_and_reference(parts)
    trainer = Trainer(model, beta=cfg["beta"],
                      clamp_targets=cfg["task"] == "edos")
    batches = [crystals[0:4], crystals[4:8], crystals[8:12]]
    losses, grad = [], None
    for b in batches:
        losses.append(trainer.train_step(collate(b))["loss"].item())
        if grad is None:
            grad = {k: p.grad.clone() for k, p in model.named_parameters()}
    ref_losses, ref_grad, ref_after = reference.train_steps(
        state, cfg, [reference.Chunk(b, cfg["task"], "cpu")
                     for b in batches], cfg["beta"])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for k, p in model.named_parameters():
        g = ref_grad[k]
        assert (grad[k] - g).abs().max() <= 1e-4 * max(1e-3, g.abs().max()), k
        assert torch.allclose(p.detach(), ref_after[k], rtol=1e-4,
                              atol=1e-6), k


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_and_the_reference_none_of_the_port():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    ref = {n.split(".")[0] for n in _imports(BENCH / "reference.py")}
    assert ref <= {"__future__", "math", "typing", "numpy", "torch"}, ref


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or the JAX package (the port's own
    name begins with the JAX package's, so names are compared whole)."""
    code = ("import perfbench.run, perfbench.drivers, perfbench.control, "
            "perfbench.trace, perfbench.work;"
            "import dostransformer_tpu_torch.train.trainer, "
            "dostransformer_tpu_torch.train.device_dataset, "
            "dostransformer_tpu_torch.models.registry, "
            "dostransformer_tpu_torch.models.import_torch;"
            "from perfbench.run import forbidden_modules, reader;"
            "[reader(p.stem) for p in perfbench.run.ROOT.glob('metrics/*.py')];"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
