"""Batched rigid-body ``Pose``: position ``p`` (..., 3) and wxyz quaternion
``q`` (..., 4). Port of ``maniskill_tpu/math/pose.py`` (the parts PickCube's
path needs)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .rotations import quat_apply, quat_conjugate, quat_mul


@dataclass
class Pose:
    p: torch.Tensor
    q: torch.Tensor

    @staticmethod
    def from_raw(raw: torch.Tensor) -> "Pose":
        """From the 7-dim raw pose ``[p, q]``."""
        return Pose(raw[..., :3], raw[..., 3:7])

    @staticmethod
    def translation(p: torch.Tensor) -> "Pose":
        """The pose translating by ``p`` (..., 3) (JAX ``Pose.create(p=p)``)."""
        return Pose(p, torch.cat([torch.ones_like(p[..., :1]), torch.zeros_like(p)], dim=-1))

    @property
    def raw(self) -> torch.Tensor:
        return torch.cat([self.p, self.q], dim=-1)

    def __mul__(self, other: "Pose") -> "Pose":
        """Compose: self ∘ other."""
        return Pose(self.p + quat_apply(self.q, other.p), quat_mul(self.q, other.q))

    def inv(self) -> "Pose":
        qi = quat_conjugate(self.q)
        return Pose(-quat_apply(qi, self.p), qi)
