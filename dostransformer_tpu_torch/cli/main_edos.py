"""eDOS training entry point (counterpart of dostransformer_tpu/cli/main_edos.py
and the reference's main_eDOS.py).

    python -m dostransformer_tpu_torch.cli.main_edos --synthetic 96 \
        --synthetic_learnable --epochs 3 --eval 1 --device cuda

Datasets:
  * --synthetic N        : N synthetic eDOS samples, split 80/10/10;
  * --dataset whole      : {data_dir}/dos_dataset_random.npz, split 80/10/10
                           as sklearn train_test_split(random_state) splits
                           it (main_eDOS.py:42-48);
  * --dataset ood_crystal / ood_element :
                           {data_dir}/train_ood_{d}.npz + test_ood_{d}.npz;
                           valid/test = halves of the OOD test set
                           (main_eDOS.py:34-39).
The npz files are written by the port's featuriser from Materials Project
records (``python -m dostransformer_tpu_torch.data.featurize_edos mp.pkl
dos.pkl {data_dir}/dos_dataset_random.npz``), or by the JAX package's, whose
files are the same. ``--embedder`` picks the family: DOSTransformer (the
default), graphnetwork, graphnetwork2, mlp or mlp2.
"""

from __future__ import annotations

import os
import sys

import torch

from dostransformer_tpu_torch.cli.common import (
    build_arg_parser,
    config_from_args,
    ln_levers_from_env,
    parse_args,
    run_training,
    runtime_kwargs,
)
from dostransformer_tpu_torch.data.datasets import (
    edos_ood_split,
    edos_random_split,
)
from dostransformer_tpu_torch.data.io import load_samples
from dostransformer_tpu_torch.data.synthetic import (
    synthetic_edos_learnable,
    synthetic_edos_samples,
)


def main(argv=None):
    args = parse_args(build_arg_parser("edos"), argv)
    cfg = config_from_args(args)
    levers = ln_levers_from_env()
    device = args.device  # the card unless --device says otherwise
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    if any(levers.values()):
        print(f"LayerNorm levers: {levers}")

    if args.synthetic:
        make = (synthetic_edos_learnable if args.synthetic_learnable
                else synthetic_edos_samples)
        train, valid, test = edos_random_split(
            make(args.synthetic, seed=cfg.random_state), cfg.random_state)
    elif cfg.dataset == "whole":
        path = os.path.join(args.data_dir, "dos_dataset_random.npz")
        if not os.path.exists(path):
            command = ("python -m dostransformer_tpu_torch.data."
                       "featurize_edos mp.pkl dos.pkl")
            sys.exit(f"dataset not found: {path}; featurize Materials "
                     f"Project records with `{command} {path}` or use "
                     f"--synthetic N")
        train, valid, test = edos_random_split(load_samples(path),
                                               cfg.random_state)
    else:
        d = cfg.dataset.replace("ood_", "")
        tr = load_samples(os.path.join(args.data_dir, f"train_ood_{d}.npz"))
        te = load_samples(os.path.join(args.data_dir, f"test_ood_{d}.npz"))
        train, valid, test = edos_ood_split(tr, te, cfg.random_state)

    print(f"train/valid/test: {len(train)}/{len(valid)}/{len(test)}")
    result = run_training("edos", cfg, train, valid, test, device=device,
                          results_dir=args.results_dir,
                          init_torch=args.init_torch,
                          debug_nans=args.debug_nans, **levers,
                          **runtime_kwargs(args))
    print(f"\nbest epoch {result['best_epoch']} | test {result['test']} | "
          f"{result['samples_per_sec']:.1f} samples/sec")
    return result


if __name__ == "__main__":
    main()
