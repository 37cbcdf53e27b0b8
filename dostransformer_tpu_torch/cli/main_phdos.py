"""phDOS training entry point (counterpart of
dostransformer_tpu/cli/main_phdos.py and the reference's main_phDOS.py).

    python -m dostransformer_tpu_torch.cli.main_phdos --synthetic 96 \
        --synthetic_learnable --epochs 3 --eval 1 --batch_size 8 --device cuda

Datasets:
  * --synthetic N : N synthetic phDOS samples, split 80/10/10;
  * otherwise     : {data_dir}/data.csv (the phononDoS tutorial's), featurised
                    on the fly (data/featurize_phdos.py, r_max 4.0 as
                    main_phDOS.py:21), split by {data_dir}/idx_{train,valid,
                    test}.txt (main_phDOS.py:47-49); when those files are
                    absent the element-balanced splitter writes them, and
                    when it leaves an empty dev split a random 80/10/10 is
                    used instead.

The reference trains phDOS in float64 at batch size 1 (main_phDOS.py:14-16,
52); the port, as the JAX package, trains in ``--dtype`` (float32 by
default; ``--x64`` widens optax's step-count scalars as the JAX package's
``--x64`` does, see cli/common.py), and ``--batch_size`` defaults to 1. The
float64 model is ``build_model("phdos", dtype="float64")`` from Python.
"""

from __future__ import annotations

import os
import sys

import torch

from dostransformer_tpu_torch.cli.common import (
    build_arg_parser,
    config_from_args,
    ln_levers_from_env,
    maybe_init_multihost,
    parse_args,
    run_training,
    runtime_kwargs,
)
from dostransformer_tpu_torch.config import PhDOSDataConfig
from dostransformer_tpu_torch.data.datasets import (
    edos_random_split,
    element_balanced_split,
    read_index_file,
)
from dostransformer_tpu_torch.data.synthetic import (
    synthetic_phdos_learnable,
    synthetic_phdos_samples,
)


def _csv_splits(data_dir: str, random_state: int):
    from dostransformer_tpu_torch.data.featurize_phdos import featurize_csv

    csv = os.path.join(data_dir, "data.csv")
    if not os.path.exists(csv):
        sys.exit(f"dataset not found: {csv}; use --synthetic N or place the "
                 f"phononDoS data.csv there")
    samples, species = featurize_csv(csv, r_max=PhDOSDataConfig.r_max)
    idx_files = [os.path.join(data_dir, f"idx_{s}.txt")
                 for s in ("train", "valid", "test")]
    if all(os.path.exists(p) for p in idx_files):
        idx = [read_index_file(p) for p in idx_files]
    else:
        idx = element_balanced_split(species, valid_size=0.1, test_size=0.1,
                                     seed=12)
        for p, ids in zip(idx_files, idx):
            with open(p, "w") as f:
                f.write("\n".join(map(str, ids)))
    train, valid, test = ([samples[i] for i in ids] for ids in idx)
    if not valid or not test:
        print("element-balanced split produced an empty dev set; "
              "falling back to a random 80/10/10 split")
        return edos_random_split(samples, random_state)
    return train, valid, test


def main(argv=None):
    args = parse_args(build_arg_parser("phdos"), argv)
    maybe_init_multihost(args)  # before anything touches the card
    cfg = config_from_args(args)
    levers = ln_levers_from_env()
    device = args.device  # the card unless --device says otherwise
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    if any(levers.values()):
        print(f"LayerNorm levers: {levers}")

    if args.synthetic:
        make = (synthetic_phdos_learnable if args.synthetic_learnable
                else synthetic_phdos_samples)
        train, valid, test = edos_random_split(
            make(args.synthetic, seed=cfg.random_state), cfg.random_state)
    else:
        train, valid, test = _csv_splits(args.data_dir, cfg.random_state)

    print(f"train/valid/test: {len(train)}/{len(valid)}/{len(test)}")
    result = run_training("phdos", cfg, train, valid, test, device=device,
                          results_dir=args.results_dir,
                          init_torch=args.init_torch,
                          debug_nans=args.debug_nans, **levers,
                          **runtime_kwargs(args))
    print(f"\nbest epoch {result['best_epoch']} | test {result['test']} | "
          f"{result['samples_per_sec']:.1f} samples/sec")
    return result


if __name__ == "__main__":
    main()
