"""Time the segment-sum kernel (csrc/segment_sum.cu) of this checkout
against the same file of another checkout, on one card, in one process.

    python3 -m dostransformer_tpu_torch.bench_segment_sum OTHER_CHECKOUT

Each checkout's ``dostransformer_tpu_torch/csrc/segment_sum.cu`` (a plain C
interface, no header of the repo) is compiled alone with nvcc into a shared
library under ``build/bench_segment_sum/`` and loaded with ctypes. At each
shape the two are checked against the plain version (F = 1 exact, else
1e-5 of the largest output) and timed in turns (other, this, this, other):
the median of 50 launches each, a spin kernel before the CUDA events as in
chip_smoke.py, beside zeros + ``index_add_``. Prints the card's name and
power limit, one line a shape, and a JSON object of the readings last.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from dostransformer_tpu_torch.ops import kernels
from dostransformer_tpu_torch.ops.segment import segment_sum_reference

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "bench_segment_sum"
# (label, B, E, F, N): the phDOS edge count (a 0/1 mask, on the model's
# path), a wide row, real crystals (~2,000 edges, up to 64 atoms), and the
# count with dropped ids
SHAPES = (("phDOS count", 8, 128, 1, 16), ("F=256", 8, 384, 256, 32),
          ("E=2048 N=64 F=1", 8, 2048, 1, 64),
          ("E=2048 N=64 F=256", 8, 2048, 256, 64),
          ("dropped ids", 8, 128, 1, 16))


def build(checkout: Path, tag: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"segment_sum_{tag}.so"
    src = checkout / "dostransformer_tpu_torch" / "csrc" / "segment_sum.cu"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.dostpu_segment_sum.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
    lib.dostpu_segment_sum.restype = ctypes.c_int
    return lib


def median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(b, e, f, n, dropped, g):
    if f == 1:
        data = (torch.rand(b, e, 1, generator=g) > 0.2).float()
    else:
        data = torch.randn(b, e, f, generator=g)
    ids = torch.randint(0, n, (b, e), generator=g, dtype=torch.int32)
    if dropped:
        ids[:, 1::7] = -1
        ids[:, 2::9] = n + 3
        data[-1] = 0.0  # a dummy graph
    return data.cuda(), ids.cuda()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: python3 -m dostransformer_tpu_torch.bench_segment_sum"
                 " OTHER_CHECKOUT")
    if not torch.cuda.is_available():
        sys.exit("bench_segment_sum: no CUDA device visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"other": build(Path(argv[0]).resolve(), "other"),
            "this": build(HERE, "this")}
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    readings = {}
    for label, b, e, f, n in SHAPES:
        data, ids = inputs(b, e, f, n, label == "dropped ids", g)
        want = segment_sum_reference(data, ids, n)
        outs = {}

        def call(tag):
            out = torch.empty(b, n, f, device="cuda")
            code = libs[tag].dostpu_segment_sum(
                data.data_ptr(), ids.data_ptr(), out.data_ptr(), b, e, f, n,
                stream)
            if code != 0:
                raise RuntimeError(f"{tag} segment sum: CUDA error {code}")
            return out

        for tag in libs:
            outs[tag] = call(tag)
            err = (outs[tag] - want).abs().max().item()
            limit = 0.0 if f == 1 else 1e-5 * max(1.0, want.abs().max().item())
            if err > limit:
                raise RuntimeError(f"{tag} at {label}: max abs err {err}")
        ok = (ids >= 0) & (ids < n)
        flat = torch.where(ok, ids + torch.arange(b, device="cuda")[:, None]
                           * n, b * n).reshape(-1).long()
        rows = data.reshape(b * e, f)
        library = lambda: torch.zeros(b * n + 1, f, device="cuda").index_add_(
            0, flat, rows)
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            times[tag].append(median_ms(lambda: call(tag)))
        lib_ms = median_ms(library)
        readings[label] = {**times, "index_add_ms": lib_ms}
        print(f"{label} (B={b} E={e} F={f} N={n}): other checkout "
              f"{times['other'][0]:.4f}, {times['other'][1]:.4f} ms; this "
              f"checkout {times['this'][0]:.4f}, {times['this'][1]:.4f} ms; "
              f"zeros + index_add_ {lib_ms:.4f} ms")
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
