"""Batch-inference entry point: featurized samples (.npz) + a training
checkpoint or a torch state_dict -> DOS spectra (.npz).

Counterpart of dostransformer_tpu/cli/main_predict.py. The weights come
from a training run's checkpoint directory (``--checkpoint_dir``: the
best-validation model under ``best/`` by default, the newest cadence
checkpoint with ``--checkpoint_state latest``) or from a
``torch.save(model.state_dict(), path)`` file, the port's or the
reference's (``--torch_state_dict``); exactly one of the two. ``--export
DIR`` writes the loaded model's served forward as a ``torch.export``
artifact and exits; ``--from_exported DIR`` serves such an artifact without
the model code (no model-shape flags, no ``--task`` unless ``--metrics``):

    python -m dostransformer_tpu_torch.cli.main_predict --task edos \
        --checkpoint_dir ckpt/ --input data.npz --output preds.npz
    python -m dostransformer_tpu_torch.cli.main_predict --task edos \
        --torch_state_dict model.pt --input data.npz --output preds.npz \
        --device cuda
    python -m dostransformer_tpu_torch.cli.main_predict --task edos \
        --checkpoint_dir ckpt/ --input data.npz --output x --export art/
    python -m dostransformer_tpu_torch.cli.main_predict --from_exported \
        art/ --input data.npz --output preds.npz

The output npz holds ``dos`` [N, bins], ``sample_id`` and ``mp_id``, as the
JAX package's main_predict writes them. ``--metrics`` also evaluates the
predictions against the samples' carried targets (per-sample RMSE/MSE/MAE
and variance-weighted r2 in float64 on the host; eDOS clamps the targets at
0), prints them as one JSON line and stores them in the npz. ``DOSTPU_FUSE_LN_ATTN=1`` in the
environment serves through the LN-fused attention kernel
(cli/common.py ``ln_levers_from_env``).
"""

from __future__ import annotations

import argparse

import numpy as np

# flags of the JAX package's main_predict that the port does not have yet,
# and where the ROADMAP brings them
_NOT_PORTED = {
    "data_parallel": "queue 1 item 9 (parallelism)",
}


def prediction_metrics(task: str, samples, dos) -> dict:
    """The reference's eval semantics on the system head, in float64 on the
    host: per-sample RMSE, MSE and MAE and the variance-weighted r2, each
    averaged over the samples. eDOS clamps the targets at 0 (the reference's
    ``test``); the eDOS predictor already clamps its predictions."""
    from dostransformer_tpu_torch.train.metrics import r2_variance_weighted

    ys = np.stack([np.asarray(s.y, np.float64) for s in samples])
    preds = np.asarray(dos, np.float64)
    if task == "edos":
        ys = np.clip(ys, 0.0, None)
    mse = ((ys - preds) ** 2).mean(axis=-1)
    return {
        "rmse": float(np.sqrt(mse).mean()),
        "mse": float(mse.mean()),
        "mae": float(np.abs(ys - preds).mean(axis=-1).mean()),
        "r2": float(np.mean([r2_variance_weighted(y, pp)
                             for y, pp in zip(ys, preds)])),
        "n": int(len(samples)),
    }


def check_sources(p: argparse.ArgumentParser, args) -> None:
    """The weight-source rules of the serving CLIs (this one and
    main_serve): at most one of a checkpoint, a state_dict and an artifact,
    and ``--checkpoint_state`` only with a checkpoint."""
    if args.from_exported and args.checkpoint_state:
        p.error("--checkpoint_state picks which checkpoint to load; an "
                "exported artifact has its weights in it")
    if args.torch_state_dict and (args.from_exported or args.checkpoint_dir
                                  or args.checkpoint_state):
        p.error("--torch_state_dict replaces the checkpoint source; give "
                "exactly one of --checkpoint_dir / --from_exported / "
                "--torch_state_dict (and no --checkpoint_state)")


def load_predictor(args, example, device):
    """The predictor of the serving CLIs' weight source: an
    ``ExportedPredictor`` for ``--from_exported`` (importing nothing of
    models/ or train/), else a ``Predictor`` of ``--task`` and the
    model-shape flags from ``--torch_state_dict`` or ``--checkpoint_dir``;
    ``example`` (one featurized sample) gives the input widths."""
    if args.from_exported:
        from dostransformer_tpu_torch.serve_dispatch import ExportedPredictor

        return ExportedPredictor(args.from_exported, device=device)
    from dostransformer_tpu_torch.cli.common import ln_levers_from_env
    from dostransformer_tpu_torch.serve import Predictor

    shape = dict(task=args.task, example=example, embedder=args.embedder,
                 layers=args.layers, t_layers=args.transformer,
                 hidden=args.hidden, batch_size=args.batch_size,
                 device=device, **ln_levers_from_env())
    if args.torch_state_dict:
        return Predictor.from_torch(args.torch_state_dict, **shape)
    return Predictor.from_checkpoint(
        args.checkpoint_dir, prefer=args.checkpoint_state or "best", **shape)


def main(argv=None):
    p = argparse.ArgumentParser("dostpu-torch-predict")
    p.add_argument("--task", choices=["edos", "phdos"],
                   help="required unless --from_exported")
    p.add_argument("--checkpoint_dir",
                   help="training checkpoint directory to serve "
                        "(--checkpoint_dir of main_edos / main_phdos)")
    p.add_argument("--checkpoint_state", choices=["best", "latest"],
                   default=None,
                   help="'best' (default) serves the best-validation model "
                        "(<dir>/best, falling back to latest when absent); "
                        "'latest' serves the newest cadence checkpoint")
    p.add_argument("--torch_state_dict", metavar="PATH",
                   help="torch.save'd state_dict (reference or port naming) "
                        "instead of a checkpoint; the model-shape flags must "
                        "match the weights")
    p.add_argument("--export", metavar="DIR",
                   help="after loading the weights, write the served forward "
                        "as a torch.export artifact (weights in it, loadable "
                        "with --from_exported without the model code) at "
                        "the input's collation geometry, and exit")
    p.add_argument("--from_exported", metavar="DIR",
                   help="serve a --export artifact instead of a checkpoint "
                        "(ignores the model-shape flags)")
    p.add_argument("--input", required=True, help="featurized samples .npz")
    p.add_argument("--output", required=True, help="predictions .npz")
    p.add_argument("--embedder", default="DOSTransformer")
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--transformer", type=int, default=2)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--metrics", action="store_true",
                   help="also evaluate the predictions against the samples' "
                        "carried targets with the reference's eval semantics "
                        "(per-sample RMSE/MSE/MAE + variance-weighted r2, "
                        "system head; eDOS clamps targets at 0): printed as "
                        "one JSON line and stored in the output npz")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; with no card visible "
                        "the run stops unless --device cpu is given)")
    for flag in _NOT_PORTED:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) is not None:
            p.error(f"--{flag} is not in the PyTorch port yet; see "
                    f"ROADMAP.md {item}")

    if args.from_exported and args.export:
        p.error("--export requires a checkpoint (--checkpoint_dir); "
                "it cannot re-export a --from_exported artifact")
    check_sources(p, args)
    if args.metrics and not args.task:
        p.error("--metrics needs --task (it picks the reference eval "
                "semantics: eDOS clamps targets at 0, phDOS does not)")

    if not (args.from_exported or (args.task and (args.checkpoint_dir
                                                  or args.torch_state_dict))):
        p.error("--task and --checkpoint_dir (or --torch_state_dict) are "
                "required unless --from_exported is given")

    from dostransformer_tpu_torch.data.io import load_samples
    from dostransformer_tpu_torch.device import cli_device

    device = cli_device(p, args.device)
    samples = load_samples(args.input)
    predictor = load_predictor(args, samples[0], device)
    if args.export:
        predictor.export(args.export, samples)
        print(f"exported serving artifact -> {args.export}")
        return None
    dos = predictor.predict(samples)
    extra = {}
    if args.metrics:
        import json

        metrics = prediction_metrics(args.task, samples, dos)
        print(json.dumps({"metrics": metrics}))
        extra = {k: np.float64(v) for k, v in metrics.items()}
    np.savez_compressed(
        args.output, dos=dos,
        sample_id=np.asarray([s.sample_id for s in samples]),
        mp_id=np.asarray([s.mp_id for s in samples]), **extra)
    print(f"predicted {dos.shape[0]} spectra ({dos.shape[1]} bins) "
          f"-> {args.output}")
    return dos


if __name__ == "__main__":
    main()
