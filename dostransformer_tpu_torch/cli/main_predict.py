"""Batch-inference entry point: featurized samples (.npz) + torch state_dict ->
DOS spectra (.npz).

Counterpart of dostransformer_tpu/cli/main_predict.py for weights saved with
``torch.save(model.state_dict(), path)`` (the port's or the reference's):

    python -m dostransformer_tpu_torch.cli.main_predict --task edos \
        --torch_state_dict model.pt --input data.npz --output preds.npz \
        --device cuda

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
    "checkpoint_dir": "queue 1 item 6 (training runtime: checkpoints)",
    "checkpoint_state": "queue 1 item 6 (training runtime: checkpoints)",
    "export": "queue 1 item 8 (serving: torch.export artifacts)",
    "from_exported": "queue 1 item 8 (serving: torch.export artifacts)",
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


def main(argv=None):
    p = argparse.ArgumentParser("dostpu-torch-predict")
    p.add_argument("--task", choices=["edos", "phdos"], required=True)
    p.add_argument("--torch_state_dict", metavar="PATH", required=True,
                   help="torch.save'd state_dict (reference or port naming); "
                        "the model-shape flags must match the weights")
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

    from dostransformer_tpu_torch.cli.common import (
        cli_device,
        ln_levers_from_env,
    )
    from dostransformer_tpu_torch.data.io import load_samples
    from dostransformer_tpu_torch.serve import Predictor

    device = cli_device(p, args.device)
    samples = load_samples(args.input)
    predictor = Predictor.from_torch(
        args.torch_state_dict, task=args.task, example=samples[0],
        embedder=args.embedder, layers=args.layers, t_layers=args.transformer,
        hidden=args.hidden, batch_size=args.batch_size, device=device,
        **ln_levers_from_env())
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
