"""phDOS edge featurisation (plain PyTorch, elementwise).

Counterpart of dostransformer_tpu/ops/geometry.py `smooth_cutoff`,
`spherical_harmonics_l1` and `edge_geometry_phdos`: the reference's e3nn
spherical harmonics (l <= 1, 'component' normalisation, normalised input)
times its smooth cutoff, computed in the model from the edge vectors.
The edge vectors are input data: nothing is differentiated through them.
"""

from __future__ import annotations

import math

import torch


def smooth_cutoff(x: torch.Tensor) -> torch.Tensor:
    """e3nn gate_points_2101.smooth_cutoff: with u = 2 (x - 1), 1 for
    u < -1, (1 - cos(pi u)) / 2 for -1 <= u <= 0, 0 for u > 0."""
    u = 2.0 * (x - 1.0)
    y = (1.0 - torch.cos(math.pi * u)) / 2.0
    y = torch.where(u > 0.0, 0.0, y)
    return torch.where(u < -1.0, 1.0, y)


def spherical_harmonics_l1(edge_vec: torch.Tensor,
                           eps: float = 1e-12) -> torch.Tensor:
    """[..., 3] -> [..., 4] = [1, sqrt(3) x / r, sqrt(3) y / r, sqrt(3) z / r];
    a zero-length vector gives [1, 0, 0, 0]."""
    r = torch.linalg.vector_norm(edge_vec, dim=-1, keepdim=True)
    unit = edge_vec / torch.clamp(r, min=eps)
    return torch.cat([torch.ones_like(r), math.sqrt(3.0) * unit], dim=-1)


def edge_geometry_phdos(edge_vec: torch.Tensor,
                        r_max: float = 4.0) -> torch.Tensor:
    """smooth_cutoff(|v| / r_max) * SH_{l<=1}(v): [..., 3] -> [..., 4]. Pad
    edges and self-loops (zero vectors) give [1, 0, 0, 0]."""
    edge_vec = edge_vec.detach()
    length = torch.linalg.vector_norm(edge_vec, dim=-1)
    return (smooth_cutoff(length / r_max)[..., None]
            * spherical_harmonics_l1(edge_vec))
