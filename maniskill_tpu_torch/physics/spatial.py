"""Spatial (6D) vector algebra in world-frame Plücker coordinates.

Port of ``maniskill_tpu/physics/spatial.py`` (the functions the engine
uses). Motion vectors are ``[ω(3); v(3)]``, force vectors ``[τ(3); f(3)]``;
all functions broadcast over leading batch dims.
"""
from __future__ import annotations

import torch

from ..math.rotations import _cross


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v × m."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, mv) + _cross(vo, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v ×* f."""
    w, vo = v[..., :3], v[..., 3:]
    ft, ff = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, ft) + _cross(vo, ff), _cross(w, ff)], dim=-1)


def point_force_to_wrench(point: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """Cartesian force at a world point (relative to the Plücker reference)
    -> spatial force at the reference."""
    return torch.cat([_cross(point, force), force], dim=-1)
