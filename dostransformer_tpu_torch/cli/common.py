"""Shared CLI plumbing: the flag surface and the epoch/eval/early-stop loop.

Counterpart of dostransformer_tpu/cli/common.py (reference main_eDOS.py:
95-188, main_phDOS.py:54-130), for both tasks: epochs over the training set,
by default resident on the device (train/device_dataset.py: uploaded once,
shuffled and batched on the device, bucketed by atom count with
``--bucketed``, features in bf16 with ``--bf16_data``), or collated on the
host and uploaded per step with ``--host_loader``; every ``--eval`` epochs
the valid set, the three-branch best tracking (a test-set eval on
improvement) and the plateau early stop; checkpoints with resume and the
best model under ``best/`` (``--checkpoint_dir``, ``--checkpoint_every``);
SIGTERM saves and exits at the next epoch boundary; optional eval artifacts
(``--export_preds``), TensorBoard scalars (``--tensorboard``) and a
``torch.profiler`` trace with the training loop's spans and counters
(``--profile_dir``, tracing.py); gradient clipping and
learning-rate schedules (``--grad_clip``, ``--warmup_epochs``,
``--cosine_lr``) and recomputation in the backward (``--remat``). At the
end the reference's ``experiments_{embedder}.txt`` block, byte for byte,
plus an optional JSONL log. The flags are the JAX package's, plus
``--device``. The flags of the JAX package's internals that the port has
no use for (ROADMAP.md's do-not-port list) are rejected, naming it.
``--attn_drop`` trains with attention dropout (the Trainer's dropout
stream, seeded from ``--seed``); ``--x64`` does what the JAX package's
does: the model keeps ``--dtype``, and the host arithmetic that
``jax_enable_x64`` widens in the JAX run, optax's step-count scalars (bias
corrections, schedules), is widened (train/optim.py ``x64``).

``--data_parallel`` and ``--tensor_parallel N`` run over the processes of a
launch (``torchrun --nproc_per_node P -m dostransformer_tpu_torch.cli.
main_edos --data_parallel ...``, one card a process; or the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``):
:func:`maybe_init_multihost` joins them before anything else, and the mesh
is ("data", "model") = (P / N, N) (N must divide P). Every rank runs the
same loop; results, JSONL, TensorBoard and artifacts are written by rank 0
only, eval metrics are gathered from the 'data' ranks, checkpoints are
collective (train/checkpoint.py), and a preemption signal on any rank stops
every rank at the same epoch boundary. The JAX package's LayerNorm levers are
selected as its users select them, through the environment
(:func:`ln_levers_from_env`); there is no flag.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from dostransformer_tpu_torch import tracing
from dostransformer_tpu_torch.config import TrainConfig, exp_get_name
from dostransformer_tpu_torch.data.datasets import GraphLoader
from dostransformer_tpu_torch.data.graph import GraphSample
from dostransformer_tpu_torch.device import cli_device, entry_device
from dostransformer_tpu_torch.models.import_torch import (
    load_reference_state_dict,
    load_torch_state_dict,
)
from dostransformer_tpu_torch.models.registry import build_model
from dostransformer_tpu_torch.nn.transformer import shard_ffn_
from dostransformer_tpu_torch.parallel.mesh import (
    any_process,
    axis_info,
    fetch_global,
    initialize_multihost,
    make_mesh,
)
from dostransformer_tpu_torch.train.artifacts import EvalArtifacts
from dostransformer_tpu_torch.train.checkpoint import (
    CheckpointManager,
    best_dir,
)
from dostransformer_tpu_torch.train.device_dataset import (
    BucketedDeviceDataset,
    DeviceDataset,
)
from dostransformer_tpu_torch.train.early_stop import BestTracker
from dostransformer_tpu_torch.train.logging import (
    JSONLLogger,
    write_experiment_result,
)
from dostransformer_tpu_torch.train.metrics import MetricAccumulator
from dostransformer_tpu_torch.train.optim import make_adamw
from dostransformer_tpu_torch.train.preemption import GracefulShutdown
from dostransformer_tpu_torch.train.tensorboard import SummaryWriter
from dostransformer_tpu_torch.train.trainer import Trainer

# flag -> (is it set?, why the port has no use for it)
_NOT_PORTED = {
    "compile_cache": (lambda a: a.compile_cache is not None,
                      "ROADMAP.md's do-not-port list (an XLA cache)"),
    "pad_bins": (lambda a: a.pad_bins != 0,
                 "ROADMAP.md's do-not-port list (TPU lane alignment)"),
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
                   help="data parallelism over the processes of a launch "
                        "(torchrun; one card a process): each takes "
                        "batch/P samples of every step")
    p.add_argument("--tensor_parallel", type=int, default=1, metavar="N",
                   help="shard the transformer FFNs over N processes "
                        "(Megatron layout; N divides the process count, "
                        "the rest form the data axis)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="checkpoint directory (with --checkpoint_every): "
                        "the latest checkpoints, the best-validation model "
                        "under best/; a run resumes from the latest")
    p.add_argument("--checkpoint_every", type=int, default=0, metavar="N",
                   help="save a checkpoint every N epochs (0: no "
                        "checkpoints, as in the JAX package)")
    p.add_argument("--log_jsonl", type=str, default=None)
    p.add_argument("--results_dir", type=str, default=".")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--export_preds", type=str, default=None, metavar="NPZ",
                   help="write test-set predictions/targets/embeddings "
                        "(the reference's preds_y structure, utils.py:93-109)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run, with "
                        "the training loop's spans and counters (trace.json, "
                        "Chrome trace format) to this directory")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection: a NaN produced "
                        "in the backward raises where it appeared")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (parameters, their gradients and the "
                        "optimizer state stay float32; LayerNorm statistics "
                        "and the softmax f32)")
    p.add_argument("--host_loader", action="store_true",
                   help="collate and upload batches from the host each step "
                        "instead of the device-resident dataset (which "
                        "uploads once and shuffles and batches on the "
                        "device)")
    p.add_argument("--bf16_data", action="store_true",
                   help="store the device dataset's node and edge features "
                        "in bfloat16 (the model casts them to its compute "
                        "dtype); targets and masks stay f32")
    p.add_argument("--bucketed", action="store_true",
                   help="partition the device dataset by atom bucket and "
                        "pad each group only to its bucket's shapes; "
                        "batches are drawn within buckets")
    p.add_argument("--pad_bins", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--remat", action="store_true",
                   help="recompute each processor and transformer layer in "
                        "the backward instead of keeping its activations")
    p.add_argument("--x64", action="store_true",
                   help="the JAX package's --x64: optax's step-count scalars "
                        "(bias corrections, schedules) in float64; the "
                        "model keeps --dtype")
    p.add_argument("--compile_cache", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--tensorboard", type=str, default=None, metavar="DIR",
                   help="also write TensorBoard scalar curves (loss, valid "
                        "and test metrics) to DIR (train/tensorboard.py)")
    p.add_argument("--init_torch", type=str, default=None, metavar="PT",
                   help="initialize params from a torch.save'd state_dict "
                        "in the reference's (or the port's) naming; a "
                        "checkpoint resume takes precedence")
    p.add_argument("--grad_clip", type=float, default=0.0, metavar="NORM",
                   help="clip gradients to this global norm (0 = off, the "
                        "reference behaviour)")
    p.add_argument("--warmup_epochs", type=int, default=0, metavar="N",
                   help="linear lr warmup 0 -> lr over the first N epochs")
    p.add_argument("--cosine_lr", action="store_true",
                   help="cosine-decay the lr to 0 over the epochs after the "
                        "warmup")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; with no card visible "
                        "the run stops unless --device cpu is given)")
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """Parse, then reject the flags of the do-not-port list (SystemExit
    naming it) and a ``--device`` that is not there (:func:`cli_device`);
    ``args.device`` becomes a ``torch.device``."""
    args = parser.parse_args(argv)
    for flag, (given, item) in _NOT_PORTED.items():
        if given(args):
            parser.error(f"--{flag} is not in the PyTorch port; see {item}")
    args.device = cli_device(parser, args.device)
    return args


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        layers=args.layers, transformer=args.transformer,
        eval_every=args.eval, es=args.es, embedder=args.embedder,
        hidden=args.hidden, random_state=args.random_state,
        dataset=args.dataset, attn_drop=args.attn_drop, seed=args.seed,
        beta=args.beta, padding=args.padding, dtype=args.dtype,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, log_jsonl=args.log_jsonl)


def runtime_kwargs(args: argparse.Namespace) -> dict:
    """The training runtime's flags as keyword arguments of
    :func:`run_training`."""
    return dict(export_preds=args.export_preds, profile_dir=args.profile_dir,
                remat=args.remat, host_loader=args.host_loader,
                tensorboard=args.tensorboard, bf16_data=args.bf16_data,
                bucketed=args.bucketed, grad_clip=args.grad_clip,
                warmup_epochs=args.warmup_epochs, cosine_lr=args.cosine_lr,
                data_parallel=args.data_parallel,
                tensor_parallel=args.tensor_parallel, x64=args.x64)


def maybe_init_multihost(args: argparse.Namespace) -> None:
    """CLI entry hook: join the processes of a launch for
    ``--data_parallel`` / ``--tensor_parallel N`` runs, before anything
    else touches the card (the JAX package's ``maybe_init_multihost``). A
    no-op in a plain single process; a launch that implies other processes
    and finds no rendezvous raises (parallel/mesh.py
    ``initialize_multihost``)."""
    if (args.data_parallel or args.tensor_parallel > 1) and \
            initialize_multihost(device=args.device):
        print(f"multi-process: rank {dist.get_rank()}/"
              f"{dist.get_world_size()} ({dist.get_backend()})")


def build_mesh(data_parallel: bool, tensor_parallel: int, device):
    """The training mesh of the parallel flags: ("data", "model") =
    (P / N, N) over the P processes of the launch, None without the flags.
    In a plain single process ``--data_parallel`` trains on its one device
    (there is nothing to split over) and ``--tensor_parallel N > 1``
    refuses."""
    if tensor_parallel < 1:
        raise SystemExit(f"--tensor_parallel must be >= 1, got "
                         f"{tensor_parallel}")
    if not data_parallel and tensor_parallel == 1:
        return None
    if not dist.is_initialized():
        if tensor_parallel > 1:
            raise SystemExit(
                f"--tensor_parallel {tensor_parallel} needs "
                f"{tensor_parallel} processes: launch with torchrun "
                f"--nproc_per_node {tensor_parallel}")
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise SystemExit(
                f"--data_parallel in a single process trains on one of the "
                f"{torch.cuda.device_count()} visible cards: launch one "
                f"process a card with torchrun --nproc_per_node "
                f"{torch.cuda.device_count()}")
        return None
    world = dist.get_world_size()
    if world % tensor_parallel:
        raise SystemExit(f"--tensor_parallel {tensor_parallel} does not "
                         f"divide the {world} processes")
    return make_mesh((world // tensor_parallel, tensor_parallel),
                     ("data", "model"))


def run_training(task: str, cfg: TrainConfig, train: Sequence[GraphSample],
                 valid: Sequence[GraphSample], test: Sequence[GraphSample],
                 device="cuda", results_dir: str = ".",
                 init_torch: Optional[str] = None,
                 debug_nans: bool = False, fuse_ln_attn: bool = False,
                 ln_lp: bool = False, *, export_preds: Optional[str] = None,
                 profile_dir: Optional[str] = None, remat: bool = False,
                 host_loader: bool = False, tensorboard: Optional[str] = None,
                 bf16_data: bool = False, bucketed: bool = False,
                 grad_clip: float = 0.0, warmup_epochs: int = 0,
                 cosine_lr: bool = False, data_parallel: bool = False,
                 tensor_parallel: int = 1, x64: bool = False) -> dict:
    """Train, evaluate and early-stop; returns the final best metrics.
    eDOS clamps its training targets and its eval predictions at 0; phDOS
    clamps neither (reference utils.py:76). ``fuse_ln_attn`` and ``ln_lp``
    are the model's LayerNorm switches (:func:`ln_levers_from_env`); the
    keyword-only arguments are the training runtime's flags
    (:func:`runtime_kwargs`); ``data_parallel`` and ``tensor_parallel``
    train over the processes of a launch (:func:`build_mesh`; every rank
    calls this); ``x64`` is the JAX package's ``--x64``
    (:func:`make_adamw`'s ``x64``). Runs on ``device``, the card by
    default; with no card visible this raises unless ``device="cpu"`` is
    given.

    SIGTERM is latched from set-up on (train/preemption.py): the loop saves
    a checkpoint at the next epoch boundary and returns with
    ``"preempted": True``. The previous handler is restored even when the
    run raises."""
    stop = GracefulShutdown().install()
    try:
        return _run_training(
            stop, task, cfg, train, valid, test, device, results_dir,
            init_torch, debug_nans, fuse_ln_attn, ln_lp, export_preds,
            profile_dir, remat, host_loader, tensorboard, bf16_data,
            bucketed, grad_clip, warmup_epochs, cosine_lr, data_parallel,
            tensor_parallel, x64)
    finally:
        stop.restore()


def _run_training(stop, task, cfg, train, valid, test, device, results_dir,
                  init_torch, debug_nans, fuse_ln_attn, ln_lp, export_preds,
                  profile_dir, remat, host_loader, tensorboard, bf16_data,
                  bucketed, grad_clip, warmup_epochs, cosine_lr,
                  data_parallel, tensor_parallel, x64) -> dict:
    if bucketed and host_loader:
        raise ValueError("--bucketed requires the device-resident dataset "
                         "pipeline; drop --host_loader")
    device = entry_device(device)
    mesh = build_mesh(data_parallel, tensor_parallel, device)
    _, n_data, data_index = axis_info(mesh, "data")
    model_group, n_model, _ = axis_info(mesh, "model")
    if cfg.batch_size % n_data:
        raise SystemExit(
            f"--batch_size {cfg.batch_size} is not divisible by the "
            f"{n_data}-rank 'data' mesh axis; each rank takes "
            f"batch/{n_data} samples — pick a multiple of {n_data}")
    # results, logs and artifacts: one copy, from rank 0
    is_main = not dist.is_initialized() or dist.get_rank() == 0
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
                        dtype=cfg.dtype, device=device, remat=remat,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        fuse_ln_attn=fuse_ln_attn, ln_lp=ln_lp,
                        tp_axis="model" if n_model > 1 else None, **widths)
    ckpt = best_ckpt = restored = None
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        ckpt = CheckpointManager(cfg.checkpoint_dir)
    if init_torch:
        # into the whole model, before a tensor-parallel run shards it
        if ckpt is not None and ckpt.latest_epoch() is not None:
            print(f"checkpoint resume takes precedence; ignoring "
                  f"--init_torch {init_torch}")
        else:
            load_reference_state_dict(model, load_torch_state_dict(init_torch))
            print(f"initialized params from torch state_dict {init_torch}")
    if n_model > 1:
        shard_ffn_(model, "model", model_group)
    # schedule horizons are in optimizer steps, from the loader (the
    # device dataset takes as many steps an epoch)
    steps_per_epoch = len(loader)
    optimizer = make_adamw(
        model.parameters(), cfg.lr, cfg.weight_decay, grad_clip=grad_clip,
        warmup_steps=warmup_epochs * steps_per_epoch,
        cosine_decay_steps=(max(0, cfg.epochs - warmup_epochs)
                            * steps_per_epoch if cosine_lr else 0), x64=x64)
    trainer = Trainer(model, optimizer, beta=cfg.beta, clamp_targets=is_edos,
                      eval_clamp=is_edos, mesh=mesh, seed=cfg.seed)

    # eval batches at the training batch size (the metrics are per-sample,
    # so any size gives the reference's batch-1 means; under a mesh the
    # largest multiple of the 'data' axis that fits it), shapes pinned to
    # cover the training buckets; collated once, uploaded once, kept on the
    # host too for the metric and artifact bookkeeping
    eval_bs = (max(n_data, cfg.batch_size - cfg.batch_size % n_data)
               if mesh is not None else max(1, cfg.batch_size))
    eval_samples = list(valid) + list(test)
    a_pin = max([loader.atoms_per_graph] + [s.n_nodes for s in eval_samples])
    e_pin = max([loader.edges_per_graph]
                + [max(s.n_edges, 1) for s in eval_samples])

    def eval_batches(samples):
        host = list(GraphLoader(samples, batch_size=eval_bs,
                                atoms_per_graph=a_pin, edges_per_graph=e_pin))
        return host, [b.to(device) for b in host]

    valid_batches, test_batches = eval_batches(valid), eval_batches(test)

    def run_eval(batches, artifacts=None):
        # every batch on the device (each rank runs its rows), then one copy
        # of the stacked metrics, joined over the 'data' ranks
        host, on_device = batches
        ms = fetch_global(trainer.eval_epoch(on_device), mesh, dim=1)
        acc = MetricAccumulator()
        for i, batch in enumerate(host):
            m = {k: v[i] for k, v in ms.items()}
            acc.update(m)
            if artifacts is not None:
                artifacts.update(m, batch)
        return acc.result()

    tracker = BestTracker(es=cfg.es, eval_every=cfg.eval_every)
    if ckpt is not None:
        # the best-validation model is kept apart (one kept): after early
        # stopping the latest cadence checkpoint is not the model the
        # reported test metrics describe, and serving loads best/. Its saves
        # go by a MONOTONIC ordinal with the true epoch beside it: a
        # resumed run can find a new best at an epoch at or below the one
        # in best/ (the restored state predates that best), and a save at a
        # step that does not increase is refused
        best_ckpt = CheckpointManager(best_dir(cfg.checkpoint_dir),
                                      max_to_keep=1)
        best_ordinal = best_ckpt.latest_epoch()
        best_ordinal = -1 if best_ordinal is None else best_ordinal
        restored = ckpt.restore(model, optimizer, rng=trainer.dropout_rng)
    start_epoch = 0
    if restored is not None:
        start_epoch, saved_tracker = restored
        tracker = saved_tracker or tracker
        print(f"resumed from epoch {start_epoch}")

    device_data = None
    if not host_loader:
        storage = torch.bfloat16 if bf16_data else None
        # under a mesh each 'data' rank uploads only its block
        shard = (data_index, n_data)
        if bucketed:
            device_data = BucketedDeviceDataset.from_samples(
                train, cfg.batch_size, storage_dtype=storage, device=device,
                shard=shard)
            kb = ", ".join(f"A={a}:{d.num_samples}"
                           for a, d in device_data.buckets)
            print(f"bucketed training: {kb}")
        else:
            device_data = DeviceDataset.from_samples(
                train, cfg.batch_size, atoms_per_graph=loader.atoms_per_graph,
                edges_per_graph=loader.edges_per_graph, storage_dtype=storage,
                device=device, shard=shard)
    logger = JSONLLogger(cfg.log_jsonl if is_main else None)
    tb = SummaryWriter(tensorboard) if tensorboard and is_main else None
    profiler = None
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    n_steps = 0
    stopped_early = preempted = False
    epoch = start_epoch
    with torch.autograd.set_detect_anomaly(debug_nans):
        t_start = time.perf_counter()
        while epoch < cfg.epochs:
            # on the device dataset the epochs up to the next eval (or
            # checkpoint) run back to back and their losses come to the
            # host once; each epoch's order derives from (seed, epoch), so
            # resume replays an uninterrupted run's order
            if device_data is not None:
                bound = min(cfg.epochs,
                            (epoch // cfg.eval_every + 1) * cfg.eval_every)
                if ckpt is not None:
                    bound = min(bound, (epoch // cfg.checkpoint_every + 1)
                                * cfg.checkpoint_every)
                epochs_fn = (trainer.train_epochs_buckets if bucketed
                             else trainer.train_epochs_device)
                losses = epochs_fn(device_data, cfg.seed,
                                   range(epoch, bound))
            else:
                losses = trainer.train_epoch(loader, epoch)[None]
            n_steps += losses.numel()
            epoch_losses = losses.mean(1).tolist()  # one copy to the host
            for i, mean_loss in enumerate(epoch_losses, epoch + 1):
                sys.stdout.write(f"\r[ epoch {i}/{cfg.epochs} ] "
                                 f"loss {mean_loss:.4f} ")
                sys.stdout.flush()
                logger.log({"epoch": i, "loss": mean_loss})
                if tb is not None:
                    tb.add_scalars(i, {"train/loss": mean_loss})
            epoch += len(epoch_losses)

            # a pod must AGREE on preemption (the scheduler may signal one
            # rank only): one small collective a chunk boundary
            if any_process(stop.requested):
                # a preemption's grace window is short: skip the eval
                # (resume runs it), save now, exit cleanly
                preempted = True
                if ckpt is not None:
                    ckpt.save(epoch, model, optimizer, tracker,
                              rng=trainer.dropout_rng)
                    print(f"\n[preemption] checkpoint saved at epoch {epoch}")
                break

            if epoch % cfg.eval_every == 0:
                vm = run_eval(valid_batches)
                logger.log({"epoch": epoch, "valid": vm})
                if tb is not None:
                    tb.add_scalars(epoch, {f"valid/{k}": v
                                           for k, v in vm.items()})
                if tracker.update(epoch, vm["rmse"], vm["mae"]):
                    tm = run_eval(test_batches)
                    tracker.record_test(tm)
                    logger.log({"epoch": epoch, "test": tm})
                    if tb is not None:
                        tb.add_scalars(epoch, {f"test/{k}": v
                                               for k, v in tm.items()})
                    print(f"\n[eval {epoch}] valid rmse {vm['rmse']:.4f} "
                          f"mae {vm['mae']:.4f} | test rmse "
                          f"{tm['rmse']:.4f} r2 {tm['r2']:.4f}")
                    if best_ckpt is not None:
                        best_ordinal += 1
                        best_ckpt.save(best_ordinal, model, optimizer,
                                       tracker, epoch_meta=epoch,
                                       rng=trainer.dropout_rng)
                if tracker.step_and_should_stop():
                    stopped_early = True
                    break
            if ckpt is not None and epoch % cfg.checkpoint_every == 0:
                ckpt.save(epoch, model, optimizer, tracker,
                          rng=trainer.dropout_rng)
        for manager in (ckpt, best_ckpt):
            if manager is not None:  # the saves in flight reach the disk
                manager.wait_until_finished()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t_start
    if profiler is not None:
        profiler.stop()
    if profiler is not None and is_main:
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        tracing.write_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"\nwrote a torch.profiler trace -> {profile_dir}/trace.json")
    if export_preds and not preempted:  # the grace window is short
        art = EvalArtifacts()
        run_eval(test_batches, artifacts=art)  # every rank: a collective
        mp_by_id = {int(s.sample_id): s.mp_id
                    for s in list(train) + list(valid) + list(test)}
        mp_ids = [mp_by_id.get(i, str(i))
                  for i in range(max(mp_by_id, default=-1) + 1)]
        if is_main:
            art.save(export_preds, mp_ids=mp_ids)
            print(f"\nwrote eval artifacts -> {export_preds}")
    result = {
        "best_epoch": tracker.best_epoch,
        "best_valid_rmse": tracker.best_rmse,
        "best_valid_mae": tracker.best_mae,
        "test": tracker.test_metrics,
        # train samples per second of wall time, evals included (as the
        # JAX package counts it)
        "samples_per_sec": n_steps * cfg.batch_size / max(elapsed, 1e-9),
        "stopped_early": stopped_early,
        "preempted": preempted,
    }
    logger.log({"final": result})
    logger.close()
    if tb is not None:
        tb.close()
    if is_main:
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
