"""The PyTorch port stands alone: importing it (and its serving, training,
featurising, native, offline-tool and CLI modules) pulls in neither jax,
flax, pandas nor the JAX package, because the machine with the card has none
of them."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "dostransformer_tpu_torch",
    "dostransformer_tpu_torch.data.graph",
    "dostransformer_tpu_torch.data.sample",
    "dostransformer_tpu_torch.data.synthetic",
    "dostransformer_tpu_torch.data.io",
    "dostransformer_tpu_torch.data.datasets",
    "dostransformer_tpu_torch.data.elements",
    "dostransformer_tpu_torch.data.neighbors",
    "dostransformer_tpu_torch.data.featurize_phdos",
    "dostransformer_tpu_torch.data.featurize_edos",
    "dostransformer_tpu_torch.data.cif",
    "dostransformer_tpu_torch.data.pool",
    "dostransformer_tpu_torch.data.create_store",
    "dostransformer_tpu_torch.data.convert_reference_pt",
    "dostransformer_tpu_torch.data.split_viz",
    "dostransformer_tpu_torch.native",
    "dostransformer_tpu_torch.native.build",
    "dostransformer_tpu_torch.nn.init",
    "dostransformer_tpu_torch.nn.layernorm",
    "dostransformer_tpu_torch.nn.modules",
    "dostransformer_tpu_torch.nn.transformer",
    "dostransformer_tpu_torch.ops.kernels",
    "dostransformer_tpu_torch.ops.segment",
    "dostransformer_tpu_torch.ops.fused_mp",
    "dostransformer_tpu_torch.ops.attention",
    "dostransformer_tpu_torch.ops.geometry",
    "dostransformer_tpu_torch.models.dostransformer",
    "dostransformer_tpu_torch.models.graphnetwork",
    "dostransformer_tpu_torch.models.mlp",
    "dostransformer_tpu_torch.models.phonon_baselines",
    "dostransformer_tpu_torch.models.registry",
    "dostransformer_tpu_torch.models.import_torch",
    "dostransformer_tpu_torch.serve",
    "dostransformer_tpu_torch.config",
    "dostransformer_tpu_torch.train.loss",
    "dostransformer_tpu_torch.train.metrics",
    "dostransformer_tpu_torch.train.optim",
    "dostransformer_tpu_torch.train.trainer",
    "dostransformer_tpu_torch.train.early_stop",
    "dostransformer_tpu_torch.train.logging",
    "dostransformer_tpu_torch.train.checkpoint",
    "dostransformer_tpu_torch.train.device_dataset",
    "dostransformer_tpu_torch.train.preemption",
    "dostransformer_tpu_torch.train.artifacts",
    "dostransformer_tpu_torch.train.tensorboard",
    "dostransformer_tpu_torch.cli.common",
    "dostransformer_tpu_torch.cli.main_predict",
    "dostransformer_tpu_torch.cli.main_edos",
    "dostransformer_tpu_torch.cli.main_phdos",
    "dostransformer_tpu_torch.bench_segment_sum",
]
PROBE = f"""
import importlib, sys
for name in {MODULES!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pandas",
                                    "dostransformer_tpu"))
print(",".join(bad))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", (
        f"the port imported {out.stdout.strip()}")


def test_featurisers_import_without_torch():
    """The featurisers' pool workers import their modules afresh: none of
    them pulls in torch (seconds a worker) or the JAX package."""
    probe = """
import importlib, sys
for name in ("dostransformer_tpu_torch.data.featurize_edos",
             "dostransformer_tpu_torch.data.featurize_phdos",
             "dostransformer_tpu_torch.data.pool",
             "dostransformer_tpu_torch.data.io"):
    importlib.import_module(name)
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("torch", "jax",
                                             "dostransformer_tpu"))))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported {out.stdout.strip()}"


def test_kernel_library_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """A changed CUDA source or shared header gets a new library name, so a
    stale build is never loaded."""
    import shutil

    from dostransformer_tpu_torch.ops import kernels

    for path in kernels.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path()
    assert before.parent == kernels.BUILD_DIR
    assert kernels.library_path() == before
    names = {before}
    for edited in ("attention.cu", "attention_core.cuh"):
        with open(tmp_path / edited, "a") as f:
            f.write("\n// edited\n")
        names.add(kernels.library_path())
    assert len(names) == 3


def test_every_bound_entry_point_is_defined_in_a_listed_source():
    """Each C function the loader binds is an ``extern "C"`` function of one
    of the sources it builds (there is no compiler here to say so), and every
    source in ``csrc/`` is built."""
    import re

    from dostransformer_tpu_torch.ops import kernels

    assert sorted(kernels.SOURCES) == sorted(
        p.name for p in kernels.CSRC.glob("*.cu"))
    defined = set()
    for name in kernels.SOURCES:
        text = (kernels.CSRC / name).read_text()
        defined |= set(re.findall(r'extern "C"[^(;{]*?\b(dostpu_\w+)\s*\(',
                                  text))
    assert set(kernels._SIGNATURES) == defined
