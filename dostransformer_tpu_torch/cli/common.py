"""Shared CLI plumbing: the flag surface and the epoch/eval/early-stop loop.

Counterpart of dostransformer_tpu/cli/common.py on its host-loader path
(reference main_eDOS.py:95-188, main_phDOS.py:54-130), for both tasks:
epochs over shuffled train batches collated on the host and uploaded per
step; every ``--eval`` epochs the
valid set, the three-branch best tracking (a test-set eval on improvement)
and the plateau early stop; at the end the reference's
``experiments_{embedder}.txt`` block, byte for byte, plus an optional JSONL
log. The flags are the JAX package's, plus ``--device``. Flags whose feature
is not in the port yet are rejected with the ROADMAP item that brings it.
The JAX package's LayerNorm levers are selected as its users select them,
through the environment (:func:`ln_levers_from_env`); there is no flag.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Mapping, Optional, Sequence

import torch

from dostransformer_tpu_torch.config import TrainConfig, exp_get_name
from dostransformer_tpu_torch.data.datasets import GraphLoader
from dostransformer_tpu_torch.data.graph import GraphSample
from dostransformer_tpu_torch.models.registry import build_model
from dostransformer_tpu_torch.train.early_stop import BestTracker
from dostransformer_tpu_torch.train.logging import (
    JSONLLogger,
    write_experiment_result,
)
from dostransformer_tpu_torch.train.metrics import MetricAccumulator
from dostransformer_tpu_torch.train.optim import make_adamw
from dostransformer_tpu_torch.train.trainer import Trainer

_Q1 = "ROADMAP.md queue 1"
# flag -> (is it set?, where the ROADMAP brings it)
_NOT_PORTED = {
    "data_parallel": (lambda a: a.data_parallel, f"{_Q1} item 9 (parallelism)"),
    "tensor_parallel": (lambda a: a.tensor_parallel > 1,
                        f"{_Q1} item 9 (parallelism)"),
    "checkpoint_dir": (lambda a: a.checkpoint_dir is not None,
                       f"{_Q1} item 6 (training runtime: checkpoints)"),
    "export_preds": (lambda a: a.export_preds is not None,
                     f"{_Q1} item 6 (training runtime: artifacts)"),
    "profile_dir": (lambda a: a.profile_dir is not None,
                    f"{_Q1} item 10 (benchmark: torch.profiler)"),
    "x64": (lambda a: a.x64, f"{_Q1} item 5, f64 phDOS (--x64)"),
    "remat": (lambda a: a.remat, f"{_Q1} item 6 (training runtime)"),
    "compile_cache": (lambda a: a.compile_cache is not None,
                      "ROADMAP.md's do-not-port list (an XLA cache)"),
    "tensorboard": (lambda a: a.tensorboard is not None,
                    f"{_Q1} item 6 (training runtime)"),
    "pad_bins": (lambda a: a.pad_bins != 0,
                 "ROADMAP.md's do-not-port list (TPU lane alignment)"),
    "bf16_data": (lambda a: a.bf16_data, f"{_Q1} item 6 (device dataset)"),
    "bucketed": (lambda a: a.bucketed, f"{_Q1} item 6 (device dataset)"),
    "grad_clip": (lambda a: a.grad_clip != 0.0,
                  f"{_Q1} item 6 (make_adamw extensions)"),
    "warmup_epochs": (lambda a: a.warmup_epochs != 0,
                      f"{_Q1} item 6 (make_adamw extensions)"),
    "cosine_lr": (lambda a: a.cosine_lr,
                  f"{_Q1} item 6 (make_adamw extensions)"),
    "dtype": (lambda a: a.dtype != "float32", "ROADMAP.md, the bf16 slice"),
    "attn_drop": (lambda a: a.attn_drop > 0.0,
                  f"{_Q1} item 2 (attention dropout)"),
    "use_pallas": (lambda a: a.use_pallas is not None,
                   "ROADMAP.md's do-not-port list (dispatch rules): a CUDA "
                   "tensor always takes the kernels"),
}


def ln_levers_from_env(environ: Optional[Mapping[str, str]] = None) -> dict:
    """The model's LayerNorm switches from the JAX package's lever names,
    read once at start-up: ``DOSTPU_FUSE_LN_ATTN=1`` -> ``fuse_ln_attn``
    (LayerNorm fused into the attention forward kernel); ``DOSTPU_LN_LP=1``
    or ``DOSTPU_LN_PALLAS=1`` -> ``ln_lp`` (the low-precision-residual
    LayerNorm). In the JAX package the second name additionally moves the
    backward into its kernel; here a CUDA tensor's ``layer_norm_lp``
    backward is always the kernel and a CPU tensor's always the plain
    version, so the two names mean the same. Returns keyword arguments for
    ``build_model``."""
    env = os.environ if environ is None else environ
    on = lambda name: env.get(name) == "1"
    return {"fuse_ln_attn": on("DOSTPU_FUSE_LN_ATTN"),
            "ln_lp": on("DOSTPU_LN_LP") or on("DOSTPU_LN_PALLAS")}


def build_arg_parser(task: str) -> argparse.ArgumentParser:
    """The JAX package's flags (the reference's 13, utils.py:25-43, and its
    extensions, same names and defaults) plus ``--device``."""
    p = argparse.ArgumentParser(f"dostpu-torch-{task}")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8 if task == "edos" else 1)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--transformer", type=int, default=2)
    p.add_argument("--eval", type=int, default=5)
    p.add_argument("--es", type=int, default=50)
    p.add_argument("--embedder", type=str, default="DOSTransformer")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--random_state", type=int, default=0)
    p.add_argument("--dataset", type=str, default="whole",
                   choices=["whole", "ood_crystal", "ood_element"])
    p.add_argument("--attn_drop", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--data_dir", type=str, default="./data/processed")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic samples (no dataset files)")
    p.add_argument("--synthetic_learnable", action="store_true",
                   help="with --synthetic: targets are a deterministic "
                        "function of the structure (a learnable task)")
    p.add_argument("--padding", type=str, default="mask",
                   choices=["mask", "ref"])
    p.add_argument("--use_pallas", action="store_true", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--no_pallas", dest="use_pallas", action="store_false",
                   help=argparse.SUPPRESS)
    p.add_argument("--data_parallel", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="with --checkpoint_dir (not in the port yet)")
    p.add_argument("--log_jsonl", type=str, default=None)
    p.add_argument("--results_dir", type=str, default=".")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--export_preds", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--profile_dir", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection: a NaN produced "
                        "in the backward raises where it appeared")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--host_loader", action="store_true",
                   help="collate and upload batches from the host each step "
                        "(the port's only pipeline; accepted for the JAX "
                        "package's command lines)")
    p.add_argument("--bf16_data", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--bucketed", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--pad_bins", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--remat", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--x64", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--compile_cache", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--tensorboard", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--init_torch", type=str, default=None, metavar="PT",
                   help="initialize params from a torch.save'd state_dict "
                        "in the reference's (or the port's) naming")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    p.add_argument("--warmup_epochs", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--cosine_lr", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default cuda when a card is visible, "
                        "else cpu")
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """Parse, then reject the flags whose feature is not in the port
    (SystemExit with the ROADMAP item)."""
    args = parser.parse_args(argv)
    for flag, (given, item) in _NOT_PORTED.items():
        if given(args):
            parser.error(f"--{flag} is not in the PyTorch port yet; see "
                         f"{item}")
    return args


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        layers=args.layers, transformer=args.transformer,
        eval_every=args.eval, es=args.es, embedder=args.embedder,
        hidden=args.hidden, random_state=args.random_state,
        dataset=args.dataset, attn_drop=args.attn_drop, seed=args.seed,
        beta=args.beta, padding=args.padding, dtype=args.dtype,
        log_jsonl=args.log_jsonl)


def run_training(task: str, cfg: TrainConfig, train: Sequence[GraphSample],
                 valid: Sequence[GraphSample], test: Sequence[GraphSample],
                 device="cpu", results_dir: str = ".",
                 init_torch: Optional[str] = None,
                 debug_nans: bool = False, fuse_ln_attn: bool = False,
                 ln_lp: bool = False) -> dict:
    """Train, evaluate and early-stop; returns the final best metrics.
    eDOS clamps its training targets and its eval predictions at 0; phDOS
    clamps neither (reference utils.py:76). ``fuse_ln_attn`` and ``ln_lp``
    are the model's LayerNorm switches (:func:`ln_levers_from_env`)."""
    device = torch.device(device)
    is_edos = task == "edos"
    loader = GraphLoader(train, batch_size=cfg.batch_size, shuffle=True,
                         seed=cfg.seed)
    # the input widths come from a batch (as the JAX package's lazy init
    # takes them; a phDOS batch has neither edge features nor globals);
    # drawing it advances the shuffle as the JAX loop does
    example = next(iter(loader))
    widths = {"node_in": example.nodes.shape[-1]}
    if example.edges is not None:
        widths["edge_in"] = example.edges.shape[-1]
    if example.glob is not None:
        widths["glob_in"] = example.glob.shape[-1]
    model = build_model(task, cfg.embedder, layers=cfg.layers,
                        t_layers=cfg.transformer, hidden=cfg.hidden,
                        attn_drop=cfg.attn_drop, padding=cfg.padding,
                        dtype=cfg.dtype, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        fuse_ln_attn=fuse_ln_attn, ln_lp=ln_lp, **widths)
    if init_torch:
        from dostransformer_tpu_torch.models.import_torch import (
            load_reference_state_dict,
            load_torch_state_dict,
        )

        load_reference_state_dict(model, load_torch_state_dict(init_torch))
        print(f"initialized params from torch state_dict {init_torch}")
    trainer = Trainer(model, make_adamw(model.parameters(), cfg.lr,
                                        cfg.weight_decay),
                      beta=cfg.beta, clamp_targets=is_edos,
                      eval_clamp=is_edos)

    # eval batches at the training batch size (the metrics are per-sample,
    # so any size gives the reference's batch-1 means), shapes pinned to
    # cover the training buckets; collated and uploaded once
    eval_samples = list(valid) + list(test)
    a_pin = max([loader.atoms_per_graph] + [s.n_nodes for s in eval_samples])
    e_pin = max([loader.edges_per_graph]
                + [max(s.n_edges, 1) for s in eval_samples])

    def eval_batches(samples):
        return [b.to(device) for b in GraphLoader(
            samples, batch_size=max(1, cfg.batch_size),
            atoms_per_graph=a_pin, edges_per_graph=e_pin)]

    valid_batches, test_batches = eval_batches(valid), eval_batches(test)

    def run_eval(batches):
        ms = [trainer.eval_step(b) for b in batches]
        acc = MetricAccumulator()
        for m in ms:
            acc.update(m)
        return acc.result()

    tracker = BestTracker(es=cfg.es, eval_every=cfg.eval_every)
    logger = JSONLLogger(cfg.log_jsonl)
    n_steps = 0
    stopped_early = False
    with torch.autograd.set_detect_anomaly(debug_nans):
        t_start = time.perf_counter()
        for epoch in range(1, cfg.epochs + 1):
            losses = trainer.train_epoch(loader)
            n_steps += len(losses)
            mean_loss = float(losses.mean())
            sys.stdout.write(f"\r[ epoch {epoch}/{cfg.epochs} ] "
                             f"loss {mean_loss:.4f} ")
            sys.stdout.flush()
            logger.log({"epoch": epoch, "loss": mean_loss})
            if epoch % cfg.eval_every == 0:
                vm = run_eval(valid_batches)
                logger.log({"epoch": epoch, "valid": vm})
                if tracker.update(epoch, vm["rmse"], vm["mae"]):
                    tm = run_eval(test_batches)
                    tracker.record_test(tm)
                    logger.log({"epoch": epoch, "test": tm})
                    print(f"\n[eval {epoch}] valid rmse {vm['rmse']:.4f} "
                          f"mae {vm['mae']:.4f} | test rmse {tm['rmse']:.4f} "
                          f"r2 {tm['r2']:.4f}")
                if tracker.step_and_should_stop():
                    stopped_early = True
                    break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t_start
    result = {
        "best_epoch": tracker.best_epoch,
        "best_valid_rmse": tracker.best_rmse,
        "best_valid_mae": tracker.best_mae,
        "test": tracker.test_metrics,
        # train samples per second of wall time, evals included (as the
        # JAX package counts it)
        "samples_per_sec": n_steps * cfg.batch_size / max(elapsed, 1e-9),
        "stopped_early": stopped_early,
    }
    logger.log({"final": result})
    logger.close()
    _write_results_line(cfg, result, results_dir)
    return result


def _write_results_line(cfg: TrainConfig, result: dict, results_dir: str):
    """Append-only experiments_{embedder}.txt: the reference's exact block
    (main_eDOS.py:91,167-186), the same bytes the JAX package writes."""
    os.makedirs(results_dir, exist_ok=True)
    tm = result.get("test") or {}
    nan = float("nan")
    write_experiment_result(
        os.path.join(results_dir, f"experiments_{cfg.embedder}.txt"),
        configuration=exp_get_name(cfg), best_epoch=result["best_epoch"],
        test_rmse=tm.get("rmse", nan), test_mse=tm.get("mse", nan),
        test_mae=tm.get("mae", nan), test_r2=tm.get("r2", nan),
        early_stopped=result["stopped_early"])
