"""The device an entry point runs on: the card unless the caller names
another.

Kept apart from the models and the CLIs' shared code so that serving an
exported program (``serve.ExportedPredictor``, ``main_predict
--from_exported``) imports neither.
"""

from __future__ import annotations

import argparse

import torch


def entry_device(device="cuda", how: str = 'device="cpu"') -> torch.device:
    """The device an entry point (a CLI, ``Predictor.from_torch``,
    ``ExportedPredictor``, ``run_training``) runs on: the card unless the
    caller names another. A CUDA device with no card visible raises and names
    ``how`` to ask for the CPU; an entry point never carries on on the CPU
    unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is visible (torch.cuda.is_available() is "
            f"False) and the device asked for is {str(device)!r}; pass "
            f"{how} to run on the CPU")
    return device


def cli_device(parser: argparse.ArgumentParser, device: str) -> torch.device:
    """``--device`` as a torch device; a CUDA device with no card visible
    ends the run (``parser.error``) with a message naming ``--device cpu``:
    a CLI never falls back to the CPU unasked."""
    try:
        return entry_device(device, how="--device cpu")
    except RuntimeError as e:
        parser.error(str(e))
