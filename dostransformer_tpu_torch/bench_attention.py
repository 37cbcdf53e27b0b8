"""Time the attention kernels (#3 csrc/attention.cu, #4
csrc/attention_bwd.cu) of this checkout against the same files of another
checkout, on one card, in one process.

    python3 -m dostransformer_tpu_torch.bench_attention OTHER_CHECKOUT

Each checkout's ``attention.cu`` and ``attention_bwd.cu`` (plain C
interfaces on the headers beside them) are compiled with nvcc, all four at
once, into one shared library a checkout under ``build/bench_attention/``
and loaded with ctypes. At each call (the eDOS flagship's three attention
shapes at D = 256 and 1,024, f32 and bf16, keys and values one tensor,
pad atoms masked and the last graph fully masked; the backward with the
forward's row statistics; also one call of 100 keys and two of the phDOS
flagship) both libraries' outputs are held against the
plain versions (f32 1e-5, bf16 2^-7 of the largest value) and timed in
turns (other, this, this, other): the median of 50 launches each, a spin
kernel before the CUDA events, as in chip_smoke.py. This checkout's
library is also timed with every form that takes the call forced (the C
entry points' ``form`` argument: the online, sliced and rows forms, the
last with one and with two 16-row groups a block), which is how the shape
rule of ``ops/attention.py attention_plan`` and the rows form's row groups
(csrc/attention_rows.cuh ``row_groups``) were measured. Prints the card's name
and power limit, one line a call, and a JSON object of the readings last.
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
from dostransformer_tpu_torch.ops.attention import (
    attention_bwd_reference,
    attention_plan,
    biased_attention_reference,
    key_bias,
)

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "bench_attention"
SOURCES = ("attention.cu", "attention_bwd.cu")
# (label, B, Lq, Lk): the three stacks' attention calls of the eDOS
# flagship at batch 8 (the heads' stacks run the 2B batch), one between
# them in keys, and two of the phDOS flagship's
CALLS = (("cross", 8, 201, 32), ("self", 16, 201, 201),
         ("source", 16, 201, 32), ("100 keys", 16, 201, 100),
         ("phDOS cross", 8, 51, 16), ("phDOS self", 16, 51, 51))
CASES = [(d, dtype) for d in (1024, 256)
         for dtype in (torch.float32, torch.bfloat16)]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Library:
    """One checkout's attention kernels; ``forms`` says whether its C entry
    points take a form (this design) or not (the designs before it)."""

    def __init__(self, checkout: Path, tag: str):
        csrc = checkout / "dostransformer_tpu_torch" / "csrc"
        self.forms = "int form, void* stream" in (
            csrc / "attention.cu").read_text()
        self.so = OUT / f"attention_{tag}.so"
        self.csrc = csrc

    def compile(self):
        """The nvcc processes of this library's sources, started."""
        OUT.mkdir(parents=True, exist_ok=True)
        self.objs = [OUT / f"{self.so.stem}.{Path(s).stem}.o"
                     for s in SOURCES]
        return [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c",
                                  "-o", str(o), str(self.csrc / s)])
                for o, s in zip(self.objs, SOURCES)]

    def load(self):
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", str(self.so), *map(str, self.objs)], check=True)
        lib = ctypes.CDLL(str(self.so))
        f = [_I] if self.forms else []
        lib.dostpu_attention_fwd.argtypes = ([_P] * 6 + [_I] * 4 + [_F, _I]
                                             + f + [_P])
        lib.dostpu_attention_bwd_scratch_floats.argtypes = [_I] * (
            6 if self.forms else 4)
        lib.dostpu_attention_bwd_scratch_floats.restype = ctypes.c_size_t
        lib.dostpu_attention_bwd.argtypes = ([_P] * 11 + [_I] * 4 + [_F, _I]
                                             + f + [_P])
        self.lib = lib
        return self

    def fwd(self, q, k, bias, form=-1):
        b, lq, d = q.shape
        out = torch.empty_like(q)
        stats = torch.empty(2, b, lq, device=q.device)
        bf16 = int(q.dtype == torch.bfloat16)
        extra = [form] if self.forms else []
        code = self.lib.dostpu_attention_fwd(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr(), b, lq, k.shape[1], d,
            d ** -0.5, bf16, *extra, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{self.so.name} forward: CUDA error {code}")
        return out, stats

    def bwd(self, q, k, bias, o, g, stats, form=-1):
        b, lq, d = q.shape
        lk = k.shape[1]
        bf16 = int(q.dtype == torch.bfloat16)
        extra = [form] if self.forms else []
        scratch = torch.empty(
            self.lib.dostpu_attention_bwd_scratch_floats(
                b, lq, lk, d, *([bf16] + extra if self.forms else [])),
            device=q.device)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, k))
        code = self.lib.dostpu_attention_bwd(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), bias.data_ptr(),
            o.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), scratch.data_ptr(), b, lq, lk,
            d, d ** -0.5, bf16, *extra,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{self.so.name} backward: CUDA error {code}")
        return dq, dk, dv


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


FAILED = []


def check(got, want, dtype, what):
    """Each output within the kernels' limit of the plain version's; a miss
    is printed, kept in FAILED (the run then exits non-zero) and timed."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for x, w in zip(got, want):
        err = (x.float() - w.float()).abs().max().item()
        limit = tol * max(1.0, w.float().abs().max().item())
        if not err <= limit:
            FAILED.append(f"{what}: max abs err {err:.3e} > {limit:.3e}")
            print(f"FAILED {FAILED[-1]}", flush=True)


def in_turns(fns: dict) -> dict:
    """Median ms of each callable, taken other, this, this, other (the
    middle ones for any other entries): the mean of each one's readings."""
    order = list(fns)
    turns = [order[0], *order[1:], *order[1:][::-1], order[0]]
    readings = {k: [] for k in fns}
    for k in turns:
        readings[k].append(median_ms(fns[k]))
    return {k: statistics.mean(v) for k, v in readings.items()}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: python3 -m dostransformer_tpu_torch.bench_attention "
                 "OTHER_CHECKOUT")
    if not torch.cuda.is_available():
        sys.exit("bench_attention: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"other": Library(Path(argv[0]).resolve(), "other"),
            "this": Library(HERE, "this")}
    procs = [p for lib in libs.values() for p in lib.compile()]
    if any(p.wait() for p in procs):
        sys.exit("bench_attention: nvcc failed")
    for lib in libs.values():
        lib.load()
    this = libs["this"]
    g = torch.Generator().manual_seed(16)
    dev = torch.device("cuda", 0)
    readings = []
    for d, dtype in CASES:
        for label, b, lq, lk in CALLS:
            q, k, go = (torch.randn(b, n, d, generator=g).to(dev).to(dtype)
                        for n in (lq, lk, lq))
            km = torch.ones(b, lk, dtype=torch.bool)
            if lk != lq:
                km = torch.arange(lk)[None] < torch.randint(
                    4, lk + 1, (b, 1), generator=g)
            km[-1] = False
            bias = key_bias(km.to(dev))
            plan = attention_plan(d, lk, dtype)
            want_o = (biased_attention_reference(q, k, k, bias),)
            want_g = attention_bwd_reference(q, k, k, bias, go)
            # every form this checkout has for the call, forced (the online
            # form takes f32 up to D = 512 only; the rows form, with one or
            # two 16-row groups a block, 256 keys)
            forms = {"online": 0, "sliced": 1, "rows G=1": 3, "rows G=2": 4}
            if dtype != torch.float32 or d > 512:
                del forms["online"]
            fwd, bwd = {}, {}
            for tag, lib in libs.items():
                o, st = lib.fwd(q, k, bias)
                check((o,), want_o, dtype, f"{tag} forward D={d} {label}")
                of = o.float()
                check(lib.bwd(q, k, bias, of, go, st), want_g, dtype,
                      f"{tag} backward D={d} {label}")
                fwd[tag] = lambda lib=lib: lib.fwd(q, k, bias)
                bwd[tag] = lambda lib=lib, of=of, st=st: lib.bwd(
                    q, k, bias, of, go, st)
            for form, code in forms.items():
                o, st = this.fwd(q, k, bias, code)
                check((o,), want_o, dtype, f"{form} forward D={d} {label}")
                of = o.float()
                check(this.bwd(q, k, bias, of, go, st, code), want_g, dtype,
                      f"{form} backward D={d} {label}")
                fwd[form] = lambda c=code: this.fwd(q, k, bias, c)
                bwd[form] = lambda c=code, of=of, st=st: this.bwd(
                    q, k, bias, of, go, st, c)
            row = {"d": d, "dtype": str(dtype).split(".")[-1], "call": label,
                   "shape": [b, lq, lk], "form": plan.form,
                   "fwd_ms": in_turns(fwd), "bwd_ms": in_turns(bwd)}
            readings.append(row)
            show = lambda ms: ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            print(f"D={d} {row['dtype']} {label} {b}x{lq}x{lk} (this: "
                  f"{plan.form} form): forward {show(row['fwd_ms'])}; "
                  f"backward {show(row['bwd_ms'])} (ms)", flush=True)
    print(json.dumps({"attention": readings, "failed": FAILED}))
    if FAILED:
        sys.exit(1)


if __name__ == "__main__":
    main()
