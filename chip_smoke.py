"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback).
The eDOS flagship:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the CUDA kernels from dostransformer_tpu_torch/csrc with nvcc
     (one nvcc per source, all at once);
  3. each forward kernel against its plain PyTorch version on the card at
     the shapes the flagship eDOS forward gives it (f32, TF32 off),
     including a short batch whose dummy graph has every key masked; max
     abs/rel error against the stated tolerance, and the median time of
     kernel and plain version over 50 runs (CUDA events);
  3b. each backward kernel against its plain backward at the training
     shapes (a dummy graph, random nonzero upstream gradients, a fully
     masked attention row), run twice and required to repeat bit for bit,
     timed as in 3;
  4. the serving path through the entry points a user calls: a flagship
     DOSTransformerEDOS (hidden 256, 3 processors, 2 transformer layers per
     stack, 201 bins; random weights from a seeded torch.Generator) is saved
     with torch.save, synthetic eDOS samples are written as npz, and
     requests are served through cli.main_predict and Predictor.predict: 96
     samples, 5 samples (a short batch) and a mix of small and large
     crystals (two atom buckets). Every output must be [N, 201], finite and
     >= 0 (the eDOS clamp); the kernel launch counters must show exactly 3
     fused_mp_edge and 6 fused_attention launches per batch and no backward
     launch; and the outputs must match the same model run on the CPU
     through the plain versions;
  5. samples/s for the 96-sample request;
  6. the training path through its entry point: cli.main_edos on 96
     learnable synthetic samples, 3 epochs, eval every epoch, at the full
     width (main_edos defaults, batch 8, f32). Every train step must launch
     exactly 3 + 6 forward and 3 + 6 backward kernels, every eval batch 3 + 6
     forward and no backward; the losses must be finite, the test metrics
     present and the experiments_DOSTransformer.txt block written;
  7. card against CPU: one seeded model copied to both devices, 3
     Trainer.train_steps on the same 3 batches (the last one short, with
     dummy graphs); the first step's gradients and every step's loss must
     agree within the stated tolerances;
  8. training samples/s at batch 8 over 20 steps (host collation and upload
     included, synchronised at both ends), with the card's name and power
     limit.

The phDOS flagship (DOSTransformerPhDOS: hidden 256, 3 processors, 2
transformer layers per stack, 51 bins, r_max 4.0, f32, scatter-mean):

  3c. the segment-sum kernel against its plain version: the phDOS
     NodeModel's edge count (F = 1, exact) on a batch of 8 synthetic phDOS
     samples, F = 256 at B=8 A=32 E=384, and ids out of range or negative
     with a dummy graph; each run twice and required to repeat bit for bit,
     timed as in 3;
  3d. kernels 1-4 against their plain versions at the phDOS shapes:
     message passing on synthetic phDOS batches of 8 (a dummy graph last)
     and of 1, attention at 51 queries against 16 atom keys (B=8, and the
     2B head batch), 51 energy tokens (2B) and 8 keys (B=1), forward and
     backward, with the tolerances of 3 and 3b;
  9. phDOS serving: a seeded flagship saved with torch.save serves 96
     samples through cli.main_predict --task phdos and 5 through
     Predictor.predict; outputs [N, 51] and finite (no clamp: negative
     values stay); exactly 3 fused_mp_edge, 3 batched_segment_sum and 6
     fused_attention launches per batch and no backward launch; card
     against CPU as in 4; samples/s for the 96-sample request;
  10. phDOS training through cli.main_phdos: 96 learnable synthetic samples,
     3 epochs at batch 8, then 24 samples for one epoch at the CLI's default
     batch 1. Every train step launches 3 + 3 + 6 forward and 3 + 6 backward
     kernels, every eval batch 3 + 3 + 6 and no backward; losses finite,
     test metrics present, the experiments block written;
  11. card against CPU: 3 phDOS Trainer.train_steps as in 7;
  12. phDOS training samples/s at batch 8 as in 8.

The eDOS paths must launch no batched_segment_sum (eDOS sums its messages
in the fused kernel). The line before the last is a JSON object with each
kernel's launches on the phDOS training path (and per path), error and
times (at the eDOS flagship shapes; the phDOS shapes' mean per call as
``ms_phdos``); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
             "is False); this script runs the port on the card only")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dostransformer_tpu_torch.cli import (  # noqa: E402
    main_edos,
    main_phdos,
    main_predict,
)
from dostransformer_tpu_torch.data.datasets import (  # noqa: E402
    GraphLoader,
    edos_random_split,
)
from dostransformer_tpu_torch.data.graph import bucket_size, collate  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_edos_learnable,
    synthetic_edos_samples,
    synthetic_phdos_learnable,
    synthetic_phdos_samples,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.ops import kernels  # noqa: E402
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_bwd_reference,
    dot_product_attention,
    fused_attention,
    fused_attention_bwd,
    key_bias,
)
from dostransformer_tpu_torch.ops.fused_mp import (  # noqa: E402
    fused_mp_edge,
    fused_mp_edge_bwd,
    mp_edge_bwd_reference,
    mp_edge_reference,
)
from dostransformer_tpu_torch.ops.segment import (  # noqa: E402
    batched_segment_sum,
    segment_sum_reference,
)
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

# flagship eDOS serving forward (cli/main_predict defaults) at batch 8
HIDDEN, LAYERS, T_LAYERS, BINS, BATCH = 256, 3, 2, 201, 8
# kernel vs plain version, f32 on the card: the two sum in different orders
# (and the kernel's agg avoids atomics), so they differ by f32 rounding only;
# 1e-5 relative to the output's magnitude leaves > 20x headroom over the
# errors seen at these shapes. The same bound holds per element for the
# backward kernels; their parameter gradients sum over all B*E = 3072 edges
# (the message-passing backward), so those get 1e-4
KERNEL_RTOL = 1e-5
PARAM_GRAD_RTOL = 1e-4
# whole forward on the card (kernels + cuBLAS) vs on the CPU (plain versions
# + CPU BLAS): f32 rounding accumulated through 3 processors and 6
# transformer layers
MODEL_ATOL = MODEL_RTOL = 1e-3
# train step on the card vs on the CPU: first-step gradients within
# atol 1e-3 + rtol 1e-3 (as the forward), per-step losses within rtol 1e-3
GRAD_ATOL = GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-3
# the phDOS flagship (main_phdos defaults but the batch): 51 bins
PH_BINS = 51
KERNELS = (fused_mp_edge, fused_attention, fused_mp_edge_bwd,
           fused_attention_bwd, batched_segment_sum)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    """Median device time of fn() over ``runs`` runs, by CUDA events. Before
    each run a spin kernel (about a millisecond) keeps the card busy while
    the host queues the start event, fn's launches and the end event, so the
    events bracket device work only and not the host's launch latency."""
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


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def compare(name, kernel_fn, plain_fn, rtols=None, repeat=False):
    """Run kernel and plain version on the same inputs; each output must be
    within its rtol (default KERNEL_RTOL) x max(1, max|plain|); with
    ``repeat`` a second kernel run must give the same bits. Returns
    (max abs err, max rel err, kernel ms, plain ms)."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rtols = rtols or (KERNEL_RTOL,) * len(want)
    abs_err = rel_err = 0.0
    for i, (g, w, tol) in enumerate(zip(got, want, rtols)):
        check(g.shape == w.shape, f"{name}: output {i} shape {tuple(g.shape)}"
                                  f" != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= tol * scale,
              f"{name}: output {i} max abs err {err:.3e} > {tol} x "
              f"{scale:.3g}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    if repeat:
        again = kernel_fn()
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: a second run differs (not deterministic)")
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    print(f"  {name}: max abs err {abs_err:.3e}, rel {rel_err:.3e} "
          f"(tol {'/'.join(map(str, sorted(set(rtols))))} rel)"
          f"{', repeats bit-identically' if repeat else ''}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50)")
    return abs_err, rel_err, ms, plain_ms


def attention_shapes():
    """The three stacks' attention shapes, D=256: cross (B, 201 x 32), self
    on the 2B head batch (2B, 201 x 201), source (2B, 201 x 32)."""
    return {"cross": (BATCH, BINS, 32), "self": (2 * BATCH, BINS, BINS),
            "source": (2 * BATCH, BINS, 32)}


def per_forward(per_shape):
    """Max errors and the mean time per call over a forward's six calls,
    two at each of the three shapes."""
    return tuple(f(r[i] for r in per_shape.values())
                 for i, f in ((0, max), (1, max), (2, statistics.mean),
                              (3, statistics.mean)))


def phase_kernels(dev):
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    out = {}

    # A: one processor's edge pipeline at B=8, A=32, E=384, M=2H=512, H=256
    b, a, e, m, h = BATCH, 32, 384, 2 * HIDDEN, HIDDEN
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0  # a dummy graph of a short batch: no real edges
    args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5,
            rand(h) * 0.1)
    print(f"fused_mp_edge B={b} A={a} E={e} M={m} H={h}")
    out["fused_mp_edge"] = compare("fused_mp_edge",
                                   lambda: fused_mp_edge(*args),
                                   lambda: mp_edge_reference(*args))

    # B: the three stacks' attention shapes
    per_shape = {}
    for label, (bb, lq, lk) in attention_shapes().items():
        q, k, v = rand(bb, lq, HIDDEN), rand(bb, lk, HIDDEN), rand(bb, lk, HIDDEN)
        km = None
        if lk != lq:  # atom keys: pad atoms masked, last graph all masked
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
            km[-1] = False
            km = km.to(dev)
        print(f"fused_attention {label}: B={bb} Lq={lq} Lk={lk} D={HIDDEN}"
              f"{' (last graph fully masked)' if km is not None else ''}")
        per_shape[label] = compare(
            f"fused_attention[{label}]",
            lambda: fused_attention(q, k, v, km),
            lambda: dot_product_attention(q, k, v, km))
    out["fused_attention"] = per_forward(per_shape)
    return out


def phase_backward_kernels(dev):
    g = torch.Generator().manual_seed(1)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    out = {}

    # A: one processor's edge backward at B=8, A=32, E=384, M=512, H=256
    b, a, e, m, h = BATCH, 32, 384, 2 * HIDDEN, HIDDEN
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0  # a dummy graph: every edge is padding
    args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5,
            rand(b, e, h), rand(b, a, h))
    print(f"fused_mp_edge_bwd B={b} A={a} E={e} M={m} H={h} (last graph a "
          f"dummy, nonzero upstream gradients everywhere)")
    out["fused_mp_edge_bwd"] = compare(
        "fused_mp_edge_bwd", lambda: fused_mp_edge_bwd(*args),
        lambda: mp_edge_bwd_reference(*args),
        rtols=(KERNEL_RTOL,) * 3 + (PARAM_GRAD_RTOL,) * 5, repeat=True)

    # B: attention backward at the three shapes, the last graph fully masked
    per_shape = {}
    for label, (bb, lq, lk) in attention_shapes().items():
        q, k, v, go = (rand(bb, n, HIDDEN) for n in (lq, lk, lk, lq))
        km = torch.ones(bb, lk, dtype=torch.bool)
        if lk != lq:
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
        km[-1] = False
        bias = key_bias(km.to(dev))
        o = fused_attention(q, k, v, km.to(dev))
        print(f"fused_attention_bwd {label}: B={bb} Lq={lq} Lk={lk} "
              f"D={HIDDEN} (last graph fully masked)")
        per_shape[label] = compare(
            f"fused_attention_bwd[{label}]",
            lambda: fused_attention_bwd(q, k, v, bias, o, go),
            lambda: attention_bwd_reference(q, k, v, bias, go), repeat=True)
    out["fused_attention_bwd"] = per_forward(per_shape)
    return out


def serve_requests():
    big = synthetic_edos_samples(96, seed=0)
    short = synthetic_edos_samples(5, seed=1)
    small = synthetic_edos_samples(10, seed=2, min_atoms=3, max_atoms=6)
    large = synthetic_edos_samples(6, seed=3, min_atoms=40, max_atoms=60)
    mixed = [s for pair in zip(small, large) for s in pair] + small[6:]
    return {"96": big, "5 (short batch)": short, "16 mixed": mixed}


def expected_batches(samples) -> int:
    groups = {}
    for s in samples:
        groups[bucket_size(s.n_nodes)] = groups.get(bucket_size(s.n_nodes), 0) + 1
    return sum(math.ceil(n / BATCH) for n in groups.values())


def check_dos(label, dos, n):
    check(dos.shape == (n, BINS), f"{label}: shape {dos.shape} != {(n, BINS)}")
    check(bool(np.isfinite(dos).all()), f"{label}: non-finite output")
    check(bool((dos >= 0).all()), f"{label}: negative output despite clamp")


def check_served(gpu, cpu, requests, outputs, task="") -> float:
    """Each request's card outputs against the CPU predictor's, then the
    serving rate of the 96-sample request (median of 5 calls after a warm
    one, samples/s)."""
    for label, samples in requests.items():
        ref = cpu.predict(samples)
        err = float(np.abs(outputs[label] - ref).max())
        print(f"{task}request {label}: card vs CPU plain max abs err "
              f"{err:.3e} (atol {MODEL_ATOL} + rtol {MODEL_RTOL})")
        check(np.allclose(outputs[label], ref, atol=MODEL_ATOL,
                          rtol=MODEL_RTOL),
              f"{task}{label}: card output differs from the CPU run by "
              f"{err:.3e}")
    samples = requests["96"]
    gpu.predict(samples)  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu.predict(samples)  # ends in one copy to the host: synchronised
        times.append(time.perf_counter() - t0)
    return len(samples) / statistics.median(times)


def phase_main_path(workdir):
    gen = torch.Generator().manual_seed(0)
    model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN, generator=gen)
    weights = os.path.join(workdir, "edos_flagship.pt")
    torch.save(model.state_dict(), weights)
    requests = serve_requests()
    paths = {}
    for label, samples in requests.items():
        paths[label] = os.path.join(workdir, f"request_{len(samples)}.npz")
        save_samples(paths[label], samples)

    gpu = Predictor.from_torch(weights, task="edos", example=requests["96"][0],
                               layers=LAYERS, t_layers=T_LAYERS,
                               hidden=HIDDEN, batch_size=BATCH, device="cuda")
    cpu = Predictor.from_torch(weights, task="edos", example=requests["96"][0],
                               layers=LAYERS, t_layers=T_LAYERS,
                               hidden=HIDDEN, batch_size=BATCH, device="cpu")

    reset_launches()
    outputs, total_batches = {}, 0
    for label, samples in requests.items():
        before = (fused_mp_edge.launches, fused_attention.launches)
        if label == "96":
            out_path = os.path.join(workdir, "preds_96.npz")
            main_predict.main([
                "--task", "edos", "--torch_state_dict", weights,
                "--input", paths[label], "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
                check(list(z["sample_id"]) == [s.sample_id for s in samples],
                      "CLI output sample_id order")
                check(list(z["mp_id"]) == [s.mp_id for s in samples],
                      "CLI output mp_id order")
        else:
            dos = gpu.predict(samples)
        n_batches = expected_batches(samples)
        total_batches += n_batches
        mp = fused_mp_edge.launches - before[0]
        attn = fused_attention.launches - before[1]
        print(f"request {label}: {n_batches} batches, fused_mp_edge "
              f"launches {mp}, fused_attention launches {attn}")
        check(mp == LAYERS * n_batches,
              f"{label}: {mp} fused_mp_edge launches, expected "
              f"{LAYERS * n_batches}")
        check(attn == 3 * T_LAYERS * n_batches,
              f"{label}: {attn} fused_attention launches, expected "
              f"{3 * T_LAYERS * n_batches}")
        check_dos(label, dos, len(samples))
        outputs[label] = dos
    launches = read_launches()
    print(f"serving path: {total_batches} batches, launches {launches}")
    check(launches["fused_mp_edge_bwd"] == launches["fused_attention_bwd"]
          == 0, "serving launched a backward kernel")
    check(launches["batched_segment_sum"] == 0,
          "eDOS serving launched batched_segment_sum (eDOS sums messages)")

    return launches, check_served(gpu, cpu, requests, outputs)


def run_counted(cli, argv):
    """Run a training entry point with the kernel launches of every
    Trainer.train_step and Trainer.eval_step counted, the counts set to 0
    just before; returns (result, per-call launches, the run's launches)."""
    per_call = {"train": [], "eval": []}
    originals = (Trainer.train_step, Trainer.eval_step)

    def counted(kind, fn):
        def wrapper(self, batch):
            before = read_launches()
            out = fn(self, batch)
            per_call[kind].append({k: v - before[k]
                                   for k, v in read_launches().items()})
            return out
        return wrapper

    Trainer.train_step = counted("train", originals[0])
    Trainer.eval_step = counted("eval", originals[1])
    reset_launches()
    try:
        result = cli.main(argv)
    finally:
        Trainer.train_step, Trainer.eval_step = originals
    return result, per_call, read_launches()


def check_training_run(label, result, per_call, want_train, n_steps, log,
                       workdir, epochs):
    """Launches per train step (want_train) and per eval batch (the same
    forward, no backward), the step count, finite epoch losses, test
    metrics and the experiments block."""
    print(f"\n{label}: {len(per_call['train'])} train steps, "
          f"{len(per_call['eval'])} eval batches")
    want_eval = dict(want_train, fused_mp_edge_bwd=0, fused_attention_bwd=0)
    check(len(per_call["train"]) == n_steps,
          f"{label}: {len(per_call['train'])} train steps, expected "
          f"{n_steps}")
    for kind, want in (("train", want_train), ("eval", want_eval)):
        bad = [c for c in per_call[kind] if c != want]
        check(not bad, f"{label}: {kind} step launches {bad[:1]}, expected "
                       f"{want}")
    check(per_call["eval"], f"{label}: no eval batch ran")
    with open(log) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    print(f"{label}: epoch losses {losses}; test metrics {result['test']}")
    check(len(losses) == epochs and all(math.isfinite(x) for x in losses),
          f"{label}: epoch losses {losses}")
    check(result["test"] is not None
          and all(math.isfinite(v) for v in result["test"].values()),
          f"{label}: test metrics {result['test']}")
    with open(os.path.join(workdir, "experiments_DOSTransformer.txt")) as f:
        block = f.read()
    check("best RMSE : " in block and "hidden(256)" in block,
          f"{label}: experiments block: {block!r}")


def phase_training_path(workdir):
    """cli.main_edos at the full width; per-call launch counts of every
    train and eval step."""
    log = os.path.join(workdir, "train.jsonl")
    result, per_call, launches = run_counted(main_edos, [
        "--synthetic", "96", "--synthetic_learnable", "--epochs", "3",
        "--eval", "1", "--layers", str(LAYERS), "--transformer",
        str(T_LAYERS), "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
        "--device", "cuda", "--results_dir", workdir, "--log_jsonl", log])
    print(f"\ntraining path: launches {launches}")
    want_train = {"fused_mp_edge": LAYERS, "fused_attention": 3 * T_LAYERS,
                  "fused_mp_edge_bwd": LAYERS,
                  "fused_attention_bwd": 3 * T_LAYERS,
                  "batched_segment_sum": 0}
    n_train = len(edos_random_split(range(96))[0])  # main_edos's split
    check_training_run("eDOS training path", result, per_call, want_train,
                       3 * math.ceil(n_train / BATCH), log, workdir, 3)
    return launches


def phase_card_vs_cpu(task: str):
    """3 Trainer.train_steps of one seeded model on both devices, the last
    batch short (dummy graphs); eDOS clamps its targets, phDOS does not."""
    learnable = (synthetic_edos_learnable if task == "edos"
                 else synthetic_phdos_learnable)
    clamp = task == "edos"
    cpu_model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                            hidden=HIDDEN,
                            generator=torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batches = list(GraphLoader(learnable(21, seed=5), BATCH))
    cpu = Trainer(cpu_model, clamp_targets=clamp, eval_clamp=clamp)
    gpu = Trainer(gpu_model, clamp_targets=clamp, eval_clamp=clamp)
    for step, batch in enumerate(batches):
        lc = cpu.train_step(batch)["loss"].item()
        lg = gpu.train_step(batch)["loss"].item()
        print(f"  step {step}: loss card {lg:.7f}, CPU {lc:.7f}")
        check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
              f"{task} step {step}: card loss {lg} vs CPU {lc}")
        if step == 0:
            worst, worst_name = 0.0, ""
            for (name, pc), pg in zip(cpu_model.named_parameters(),
                                      gpu_model.parameters()):
                gg = pg.grad.cpu()
                err = (gg - pc.grad).abs().max().item()
                if err > worst:
                    worst, worst_name = err, name
                check(torch.allclose(gg, pc.grad, atol=GRAD_ATOL,
                                     rtol=GRAD_RTOL),
                      f"{task} first-step gradient of {name} differs by "
                      f"{err:.3e}")
            print(f"  first-step gradients: card vs CPU max abs err "
                  f"{worst:.3e} ({worst_name}; atol {GRAD_ATOL} + rtol "
                  f"{GRAD_RTOL})")


def phase_train_rate(task: str, steps: int = 20) -> float:
    learnable = (synthetic_edos_learnable if task == "edos"
                 else synthetic_phdos_learnable)
    clamp = task == "edos"
    model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN, device="cuda",
                        generator=torch.Generator().manual_seed(2))
    trainer = Trainer(model, clamp_targets=clamp, eval_clamp=clamp)
    batches = list(GraphLoader(learnable(96, seed=0), BATCH))
    for batch in batches[:2]:  # warm
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    return steps * BATCH / (time.perf_counter() - t0)


# --- the phDOS flagship --------------------------------------------------


def phase_segment_sum(dev):
    """3c: the segment-sum kernel against its plain version: the phDOS
    NodeModel's edge count (F = 1) on a batch of 8 synthetic phDOS samples,
    F = 256 at B=8 A=32 E=384, and dropped ids with a dummy graph."""
    g = torch.Generator().manual_seed(4)
    batch = collate(synthetic_phdos_samples(BATCH, seed=0)).to(dev)
    b, e = batch.edge_mask.shape
    a = batch.atoms_per_graph
    count = batch.edge_mask[..., None]
    print(f"batched_segment_sum phDOS count: B={b} E={e} F=1 N={a} (the "
          f"edge mask onto the receivers)")
    runs = [compare("batched_segment_sum[count]",
                    lambda: batched_segment_sum(count, batch.receivers, a),
                    lambda: segment_sum_reference(count, batch.receivers, a),
                    repeat=True)]
    check(torch.equal(batched_segment_sum(count, batch.receivers, a),
                      segment_sum_reference(count, batch.receivers, a)),
          "batched_segment_sum: the F=1 edge counts are not exact")

    data = torch.randn(BATCH, 384, HIDDEN, generator=g).to(dev)
    ids = torch.randint(0, 32, (BATCH, 384), generator=g,
                        dtype=torch.int32).to(dev)
    print(f"batched_segment_sum wide: B={BATCH} E=384 F={HIDDEN} N=32")
    runs.append(compare(f"batched_segment_sum[F={HIDDEN}]",
                        lambda: batched_segment_sum(data, ids, 32),
                        lambda: segment_sum_reference(data, ids, 32),
                        repeat=True))

    short = collate(synthetic_phdos_samples(BATCH - 1, seed=1),
                    num_graphs=BATCH).to(dev)
    n = short.atoms_per_graph
    ids = short.receivers.clone()
    ids[:, 1::7] = -1
    ids[:, 2::9] = n + 3
    mask = short.edge_mask[..., None]
    print(f"batched_segment_sum edge cases: B={BATCH} (last graph a dummy) "
          f"E={ids.shape[1]} F=1 N={n}, ids -1 and N+3 dropped")
    runs.append(compare("batched_segment_sum[dropped ids, dummy graph]",
                        lambda: batched_segment_sum(mask, ids, n),
                        lambda: segment_sum_reference(mask, ids, n),
                        repeat=True))
    err = max(r[0] for r in runs)
    rel = max(r[1] for r in runs)
    return {"batched_segment_sum": (err, rel, runs[0][2], runs[0][3])}


def phase_phdos_kernels(dev):
    """3d: kernels #1-#4 against their plain versions at the phDOS shapes:
    message passing on synthetic phDOS batches of 8 (7 crystals and a dummy
    graph) and of 1; attention with 51 queries against 16 atom keys (cross,
    source) or 51 energy tokens (self), and at batch 1 against 8 keys."""
    g = torch.Generator().manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    m, h = 2 * HIDDEN, HIDDEN
    runs = {name: {} for name in ("fused_mp_edge", "fused_mp_edge_bwd",
                                  "fused_attention", "fused_attention_bwd")}
    for label, n, slots in (("B=8", BATCH - 1, BATCH), ("B=1", 1, 1)):
        batch = collate(synthetic_phdos_samples(n, seed=2),
                        num_graphs=slots).to(dev)
        b, a, e = slots, batch.atoms_per_graph, batch.edges_per_graph
        fwd = (rand(b, a, m), rand(b, a, m), rand(b, e, m), batch.senders,
               batch.receivers, batch.edge_mask, rand(m).abs() + 0.5,
               rand(m) * 0.1, torch.tensor([0.25], device=dev),
               rand(h, m) * m ** -0.5, rand(h) * 0.1)
        bwd = fwd[:10] + (rand(b, e, h), rand(b, a, h))
        print(f"fused_mp_edge phDOS {label}: A={a} E={e} M={m} H={h}")
        runs["fused_mp_edge"][label] = compare(
            f"fused_mp_edge[phDOS {label}]", lambda: fused_mp_edge(*fwd),
            lambda: mp_edge_reference(*fwd))
        runs["fused_mp_edge_bwd"][label] = compare(
            f"fused_mp_edge_bwd[phDOS {label}]",
            lambda: fused_mp_edge_bwd(*bwd),
            lambda: mp_edge_bwd_reference(*bwd),
            rtols=(KERNEL_RTOL,) * 3 + (PARAM_GRAD_RTOL,) * 5, repeat=True)

    shapes = {"cross B=8": (BATCH, PH_BINS, 16), "self 2B": (2 * BATCH,
              PH_BINS, PH_BINS), "source 2B": (2 * BATCH, PH_BINS, 16),
              "cross B=1": (1, PH_BINS, 8)}
    for label, (bb, lq, lk) in shapes.items():
        q, k, v, go = (rand(bb, n, HIDDEN) for n in (lq, lk, lk, lq))
        km = None
        if lk != lq:  # atom keys: pad atoms masked
            n_real = torch.randint(2, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
            if bb > 1:
                km[-1] = False  # a dummy graph: every key masked
            km = km.to(dev)
        bias = (key_bias(km) if km is not None
                else torch.zeros(bb, lk, device=dev))
        o = fused_attention(q, k, v, km)
        print(f"fused_attention phDOS {label}: B={bb} Lq={lq} Lk={lk} "
              f"D={HIDDEN}")
        runs["fused_attention"][label] = compare(
            f"fused_attention[phDOS {label}]",
            lambda: fused_attention(q, k, v, km),
            lambda: dot_product_attention(q, k, v, km))
        runs["fused_attention_bwd"][label] = compare(
            f"fused_attention_bwd[phDOS {label}]",
            lambda: fused_attention_bwd(q, k, v, bias, o, go),
            lambda: attention_bwd_reference(q, k, v, bias, go), repeat=True)
    return {name: per_forward(r) for name, r in runs.items()}


def phase_phdos_serving(workdir):
    """9: a seeded flagship DOSTransformerPhDOS saved with torch.save and
    served through main_predict --task phdos (96 samples) and
    Predictor.predict (5); no clamp, so outputs may be negative."""
    model = build_model("phdos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    weights = os.path.join(workdir, "phdos_flagship.pt")
    torch.save(model.state_dict(), weights)
    requests = {"96": synthetic_phdos_samples(96, seed=0),
                "5 (short batch)": synthetic_phdos_samples(5, seed=1)}
    path = os.path.join(workdir, "phdos_request_96.npz")
    save_samples(path, requests["96"])
    kw = dict(task="phdos", example=requests["96"][0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=HIDDEN, batch_size=BATCH)
    gpu = Predictor.from_torch(weights, device="cuda", **kw)
    cpu = Predictor.from_torch(weights, device="cpu", **kw)
    check(not gpu.clamp, "the phDOS predictor clamps")

    reset_launches()
    outputs = {}
    for label, samples in requests.items():
        before = read_launches()
        if label == "96":
            out_path = os.path.join(workdir, "phdos_preds_96.npz")
            main_predict.main([
                "--task", "phdos", "--torch_state_dict", weights,
                "--input", path, "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
                check(list(z["sample_id"]) == [s.sample_id for s in samples],
                      "phDOS CLI output sample_id order")
        else:
            dos = gpu.predict(samples)
        n = expected_batches(samples)
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = {"fused_mp_edge": LAYERS * n, "fused_attention": 3 * T_LAYERS * n,
                "fused_mp_edge_bwd": 0, "fused_attention_bwd": 0,
                "batched_segment_sum": LAYERS * n}
        print(f"phDOS request {label}: {n} batches, launches {got}")
        check(got == want, f"phDOS request {label}: launches {got}, expected "
                           f"{want}")
        check(dos.shape == (len(samples), PH_BINS),
              f"phDOS {label}: shape {dos.shape}")
        check(bool(np.isfinite(dos).all()), f"phDOS {label}: non-finite")
        outputs[label] = dos
    launches = read_launches()
    print(f"phDOS serving path: launches {launches}; outputs below 0 (no "
          f"clamp): {int((outputs['96'] < 0).sum())} of {outputs['96'].size}")

    return launches, check_served(gpu, cpu, requests, outputs, "phDOS ")


def phase_phdos_training(workdir):
    """10: cli.main_phdos at the full width, batch 8, 3 epochs; then one
    epoch at the CLI's default batch size 1. Returns the launches of both
    runs together."""
    want_train = {"fused_mp_edge": LAYERS, "fused_attention": 3 * T_LAYERS,
                  "fused_mp_edge_bwd": LAYERS,
                  "fused_attention_bwd": 3 * T_LAYERS,
                  "batched_segment_sum": LAYERS}
    width = ["--layers", str(LAYERS), "--transformer", str(T_LAYERS),
             "--hidden", str(HIDDEN), "--device", "cuda"]
    totals = {k.__name__: 0 for k in KERNELS}
    for label, n, epochs, batch in (("batch 8", 96, 3, BATCH),
                                    ("batch 1", 24, 1, 1)):
        run_dir = os.path.join(workdir, f"phdos_b{batch}")
        log = os.path.join(run_dir, "train.jsonl")
        argv = ["--synthetic", str(n), "--synthetic_learnable", "--epochs",
                str(epochs), "--eval", "1", *width, "--results_dir", run_dir,
                "--log_jsonl", log]
        if batch != 1:  # batch 1 is main_phdos's default
            argv += ["--batch_size", str(batch)]
        os.makedirs(run_dir)
        result, per_call, launches = run_counted(main_phdos, argv)
        n_train = len(edos_random_split(range(n))[0])  # main_phdos's split
        check_training_run(f"phDOS training path ({label})", result,
                           per_call, want_train,
                           epochs * math.ceil(n_train / batch), log, run_dir,
                           epochs)
        print(f"phDOS training path ({label}): launches {launches}")
        for k, v in launches.items():
            totals[k] += v
    return totals


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); name and power limit from nvidia-smi:")
    print(smi)

    _, seconds = kernels.build(force=True)
    kernels.library()
    print(f"built {len(kernels.SOURCES)} CUDA sources for sm_90a in "
          f"{seconds:.1f} s")

    results = phase_kernels(dev)
    results.update(phase_backward_kernels(dev))
    results.update(phase_segment_sum(dev))
    phdos_results = phase_phdos_kernels(dev)
    paths = {}
    with tempfile.TemporaryDirectory() as workdir:
        paths["edos_serving"], rate = phase_main_path(workdir)
    print(f"{rate:.1f} samples/s serving the 96-sample request (eDOS "
          f"flagship, batch {BATCH}, f32) on {smi}")
    with tempfile.TemporaryDirectory() as workdir:
        paths["edos_training"] = phase_training_path(workdir)
    print("card vs CPU, 3 eDOS train steps:")
    phase_card_vs_cpu("edos")
    rate = phase_train_rate("edos")
    print(f"{rate:.1f} samples/s training (eDOS flagship, batch {BATCH}, "
          f"f32, 20 steps, host collation and upload included) on {smi}")

    with tempfile.TemporaryDirectory() as workdir:
        paths["phdos_serving"], rate = phase_phdos_serving(workdir)
    print(f"{rate:.1f} samples/s serving the 96-sample request (phDOS "
          f"flagship, batch {BATCH}, f32) on {smi}")
    with tempfile.TemporaryDirectory() as workdir:
        paths["phdos_training"] = phase_phdos_training(workdir)
    print("card vs CPU, 3 phDOS train steps:")
    phase_card_vs_cpu("phdos")
    rate = phase_train_rate("phdos")
    print(f"{rate:.1f} samples/s training (phDOS flagship, batch {BATCH}, "
          f"f32, 20 steps, host collation and upload included) on {smi}")

    csrc, tpu = "dostransformer_tpu_torch/csrc", "dostransformer_tpu"
    sources = {
        "fused_mp_edge": (f"{csrc}/fused_mp.cu", f"{tpu}/ops/fused_mp.py:79"),
        "fused_attention": (f"{csrc}/attention.cu",
                            f"{tpu}/ops/attention.py:80"),
        "fused_mp_edge_bwd": (f"{csrc}/fused_mp_bwd.cu",
                              f"{tpu}/ops/fused_mp.py:112"),
        "fused_attention_bwd": (f"{csrc}/attention_bwd.cu",
                                f"{tpu}/ops/attention.py:317"),
        "batched_segment_sum": (f"{csrc}/segment_sum.cu",
                                f"{tpu}/ops/segment.py:98")}
    # where each kernel must run: every path its model and mode reach
    forward = ("fused_mp_edge", "fused_attention", "batched_segment_sum")
    runs_on = {path: [k for k in sources
                      if (k in forward or path.endswith("training"))
                      and (k != "batched_segment_sum"
                           or path.startswith("phdos"))]
               for path in paths}
    for path, names in runs_on.items():
        for name in sources:
            launched = paths[path][name]
            if name in names:
                check(launched > 0, f"{name} never launched on {path}")
            else:
                check(launched == 0, f"{name} launched {launched} times on "
                                     f"{path}")
    rows = []
    for name, (err, _, ms, plain_ms) in results.items():
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1],
               "launches": paths["phdos_training"][name],
               "max_abs_err": max(err, phdos_results.get(name, (0.0,))[0]),
               "ms": ms, "plain_ms": plain_ms,
               "launches_by_path": {p: c[name] for p, c in paths.items()}}
        if name in phdos_results:
            row["ms_phdos"], row["plain_ms_phdos"] = phdos_results[name][2:]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
