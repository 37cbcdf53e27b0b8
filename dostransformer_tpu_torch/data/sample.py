"""One featurised crystal on the host, without torch.

:class:`GraphSample` is field for field the JAX package's, so one npz file
serves both packages. It lives apart from data/graph.py (which re-exports
it), so the featurisers and their pool workers import numpy and not torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class GraphSample:
    """One featurized crystal (host-side numpy)."""

    x: np.ndarray                     # [n, Fx] node features
    edge_index: np.ndarray            # [2, e] int (senders; receivers)
    y: np.ndarray                     # [bins] target
    system: int = 6                   # crystal-system id 0..6
    edge_attr: Optional[np.ndarray] = None    # [e, Fe] eDOS Gaussian expansion
    edge_vec: Optional[np.ndarray] = None     # [e, 3] phDOS geometry
    edge_shift: Optional[np.ndarray] = None   # [e, 3] phDOS
    z: Optional[np.ndarray] = None            # one-hot atom type
    coords: Optional[np.ndarray] = None       # [n_atoms, 3] (data only)
    glob: Optional[np.ndarray] = None         # [2] eDOS global features
    sample_id: int = 0
    mp_id: str = ""
    y_raw: Optional[np.ndarray] = None
    y_max: Optional[float] = None
    band_gap: Optional[float] = None
    efermi: Optional[float] = None

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_index.shape[1])
