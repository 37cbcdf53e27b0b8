"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
limits and per-layer metric readers are found by the names in
``BENCHMARK.json``. The run loads the port, makes its inputs and weights
from the seed, warms every shape its traffic uses (``setup_s``: from the
start of the process to the first timed step), then measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or profiles
a few whole epochs (``--trace 1``: its per-layer metrics), frees the
program's state, runs the plain reference and prints one JSON line last
on standard output. It needs the card: without one, or
with fewer cards than the cell asks for, it exits with code 2 and prints
no result; it exits with code 3 if the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent          # perfbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dostransformer_tpu")


HOST_THREADS = "2"


def run_env(checkout: Path = CHECKOUT) -> None:
    """Every compiler cache a run could touch, at fixed paths inside the
    checkout (the port's own kernel library lives in ``build/
    torch_kernels``, where ``ops/kernels.py`` puts it); and two host
    threads for torch's and numpy's CPU work, set before either is
    imported: with one a core, runs on a shared host spread by a third
    (on an H100 host of 8 cores, a host-paced loop serving phDOS spectra
    through ``Predictor.predict`` answered 326 to 526 requests in 20 s
    with every core, 428 to 443 with two)."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[name] = HOST_THREADS
    base = checkout / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and limits, each read from its own file, and the metrics
    it reports."""
    bench = load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root.parent / configs[cell["config"]]["file"])
    return {
        "cell": cell,
        "cfg": cfg,
        "mix": load_json(root / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "limits" / f"{name}.json"),
        "end_to_end": reported(bench["end_to_end"], name),
        "per_layer": reported(bench["per_layer"], name, bench["end_to_end"]),
    }


def reported(metrics: list, cell: str, end_to_end: list = ()) -> list:
    """The metrics a cell reports: those that list it, or that list no
    cells and (for a per-layer metric) move an end-to-end metric the cell
    reports."""
    mine = {m["name"] for m in reported(end_to_end, cell)} if end_to_end \
        else None
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif mine is None or m["moves"] in mine:
            out.append(m)
    return out


def reader(name: str, root: Path = ROOT):
    """The ``read(span)`` function of the per-layer metric ``name``, from
    ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Modules whose top-level name is one the port's runs must not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e!r})"


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        cell: dict | None = None) -> dict:
    """One run of the cell: the result line's fields and the checks.
    ``cell`` replaces what :func:`load_cell` reads (tests run small cells
    on the CPU)."""
    import torch

    from perfbench import reference
    from perfbench.drivers import DRIVERS

    cell = cell or load_cell(name)
    reference.strict_f32()
    driver = DRIVERS[cell["mix"]["kind"]](cell["cfg"], cell["mix"], seed,
                                          device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    # the set-up's objects (the corpus, the pool) leave the collector's
    # scans, so its pauses in the window do not grow with them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - START
    print(f"setup: {setup_s:.3f} s", flush=True)
    metrics, extra, breakdown = {}, {}, None
    if trace:
        span = driver.span()
        for m in cell["per_layer"]:
            value = reader(m["name"])(span)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(f"span: {span.units} {span.kind} units, {len(span.crystals)} "
              f"crystals, {span.window_s:.6f} s", flush=True)
        extra = {"busy_s": span.busy_s, "window_s": span.window_s}
        breakdown = span.breakdown()
    else:
        values = driver.window(seconds)
        values["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.finish()
    numbers = driver.checks()
    correct = driver.failed == 0 and all(
        math.isfinite(v) and v <= cell["limits"][k]
        for k, v in numbers.items())
    # a number that is not finite prints as null
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": cell["limits"][k]} for k, v in numbers.items()}
    line = {
        "correct": correct,
        "attempted": driver.attempted,
        "failed": driver.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["cell"]["chips"],
            "memory_peak_bytes": int(peak),
            **extra,
        },
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    run_env()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible: the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["cell"]["chips"]:
        print(f"{args.workload} needs {cell['cell']['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {power_line()}; peaks: TF32 495 TFLOP/s, 3.35 TB/s",
          flush=True)
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               cell=cell)
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
