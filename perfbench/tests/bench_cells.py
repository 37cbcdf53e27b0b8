"""Small versions of the benchmark's configurations and traffic mixes, for
the CPU tests: the same files, with the widths, depth and traffic cut
until a run takes seconds on the CPU."""

from __future__ import annotations

from perfbench.run import ROOT, load_cell, load_json

SEED = 2 ** 31 + 12345  # wider than 32 signed bits, as the driver's are

# The phDOS model of main_phDOS.py, which no cell runs yet: the reference
# is held against the port's CPU path for both tasks
PHDOS = {"task": "phdos", "hidden": 256, "layers": 3, "t_layers": 2,
         "bins": 51, "node_in": 118, "edge_in": 4, "prompts": 7,
         "r_max": 4.0, "padding": "mask", "dtype": "float32", "beta": 1.0}
PHDOS_MIX = {"kind": "train", "task": "phdos", "atoms": [2, 40],
             "neighbours": [4, 9]}


def small(cfg: dict, mix: dict):
    """``cfg`` at hidden 32, 2 processors, 1 transformer layer a stack and
    17 (eDOS) or 9 (phDOS) bins, and ``mix`` cut to 96 crystals of 4-40
    atoms at batch 8, checked on a full, a partial and a full batch."""
    cfg = dict(cfg, hidden=32, layers=2, t_layers=1,
               bins=17 if cfg["task"] == "edos" else 9)
    mix = dict(mix, crystals=96, batch_size=8, check=[[-1, 8], [-2, 5],
                                                      [0, 8]])
    if cfg["task"] == "edos":
        mix["atoms"] = [4, 40]
    return cfg, mix


def small_parts(config: str, traffic: str):
    """A configuration and a traffic mix read from their files, made
    small."""
    return small(load_json(ROOT / "configs" / f"{config}.json"),
                 load_json(ROOT / "traffic" / f"{traffic}.json"))


# (configuration, traffic mix) of each task, made small
TASKS = {"edos": lambda: small_parts("edos_h256", "edos_train_b64"),
         "phdos": lambda: small(PHDOS, PHDOS_MIX)}


def small_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``, made small."""
    cell = load_cell(name)
    cell["cfg"], cell["mix"] = small(cell["cfg"], cell["mix"])
    return cell
