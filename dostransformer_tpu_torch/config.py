"""Training configuration and data constants.

Counterpart of dostransformer_tpu/config.py `TrainConfig`, `exp_get_name`,
`PhDOSDataConfig` and `crystal_system_id`, copied because importing the JAX
package needs jax. The
reference's flag defaults (utils.py:25-43) and the run-name key order
(utils.py:51-59) are the same, so both packages write the same
``experiments_{embedder}.txt`` configuration line. The JAX package's
mesh, donation, Pallas, parameter-dtype and checkpoint fields have no
counterpart here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    """Training-driver knobs (reference utils.py:25-43 defaults)."""

    lr: float = 1e-4
    epochs: int = 1000
    batch_size: int = 8
    layers: int = 3            # number of GNN Processor steps
    transformer: int = 2       # number of transformer layers per encoder stack
    eval_every: int = 5        # "--eval"
    es: int = 50               # early-stopping criterion
    embedder: str = "DOSTransformer"
    hidden: int = 256
    random_state: int = 0      # dataset-split seed
    dataset: str = "whole"     # whole | ood_crystal | ood_element
    attn_drop: float = 0.0
    seed: int = 0
    beta: float = 1.0          # weight on the system-head RMSE
    weight_decay: float = 1e-2  # reference main_eDOS.py:93 (hard-coded)

    dtype: str = "float32"
    padding: str = "mask"      # "mask" | "ref" (zero pad atoms act as keys)
    log_jsonl: Optional[str] = None


def exp_get_name(cfg: TrainConfig) -> str:
    """Run-name string with the reference's key order (utils.py:51-59)."""
    keys = ("seed", "beta", "attn_drop", "transformer", "layers", "embedder",
            "lr", "batch_size", "hidden", "random_state", "dataset")
    d = dataclasses.asdict(cfg)
    return "".join(f"{k}({d[k]})_" for k in keys)


@dataclasses.dataclass
class PhDOSDataConfig:
    """phDOS featurisation constants (reference main_phDOS.py:21,
    utils.py:249-303)."""

    n_bins: int = 51           # embedder_phDOS/DOSTransformer_phonon.py:19
    r_max: float = 4.0         # main_phDOS.py:21
    n_atom_feats: int = 118    # row of diag(atomic_mass), Z in 1..118
    n_bond_feats: int = 4      # SH l<=1 "component" norm: 1x0e + 1x1o
    batch_size: int = 1        # main_phDOS.py:52 (hard-coded in reference)


CRYSTAL_SYSTEMS_EDOS = (
    "cubic", "hexagonal", "tetragonal", "trigonal", "orthorhombic",
    "monoclinic",
)  # ids 0..5; anything else -> 6 (mat2graph.py:94-107)

CRYSTAL_SYSTEMS_PHDOS = (
    "Cubic", "Hexagonal", "Tetragonal", "Trigonal", "Orthorhombic",
    "Monoclinic",
)  # ids 0..5; anything else -> 6 (utils.py:277-290)


def crystal_system_id(name: str, *, phonon: bool = False) -> int:
    table = CRYSTAL_SYSTEMS_PHDOS if phonon else CRYSTAL_SYSTEMS_EDOS
    try:
        return table.index(name)
    except ValueError:
        return 6
