"""Agent layer: robot descriptors, controller assembly, proprioception.

Port of ``maniskill_tpu/agents/base_agent.py`` (``install``,
``proprioception``, URDF primitive collisions). A robot class declares its
URDF, collision material overrides, extra primitive collisions, keyframes
and controller configs; ``install`` wires it into a ``SceneSpecBuilder``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kinematics.urdf import RobotSpec, parse_urdf
from ..physics.model import SceneSpecBuilder
from ..physics.shapes import GeomType
from .controllers.base import ControllerConfig, JointController
from .controllers.composite import CompositeController

_GEOM_TYPE_BY_NAME = {"box": GeomType.BOX, "sphere": GeomType.SPHERE,
                      "capsule": GeomType.CAPSULE, "plane": GeomType.PLANE}


@dataclass
class Keyframe:
    qpos: np.ndarray


REGISTERED_AGENTS: Dict[str, type] = {}


def register_agent(cls):
    REGISTERED_AGENTS[cls.uid] = cls
    return cls


class BaseAgent:
    uid: str = "base"
    urdf_path: str = ""
    ee_link_name: Optional[str] = None
    keyframes: Dict[str, Keyframe] = {}
    link_friction: Dict[str, float] = {}
    default_friction: float = 0.3
    extra_collisions: List[dict] = []
    urdf_collision_filter: Dict[str, Sequence[int]] = {}
    balance_passive_force: bool = True

    def __init__(self, device="cpu"):
        self.robot_spec: RobotSpec = parse_urdf(self.urdf_path)
        self.nq = self.robot_spec.nb
        # one control mode per robot in this slice: its first config
        self.control_mode, cfgs = next(iter(self._controller_configs().items()))
        named = {}
        for name, cfg in cfgs.items():
            cfg.joint_indices = self._resolve_joints(cfg.joint_names)
            named[name] = JointController(cfg, self.robot_spec.qlim, device)
        self.controller = CompositeController(named, self.nq, device)

    def _controller_configs(self) -> Dict[str, Dict[str, ControllerConfig]]:
        raise NotImplementedError

    def _resolve_joints(self, names: Sequence[str]) -> np.ndarray:
        order = {n: i for i, n in enumerate(self.robot_spec.joint_names)}
        return np.array([order[n] for n in names], dtype=np.int32)

    def collision_geoms(self) -> List[dict]:
        """URDF primitives (with per-link materials) + declared extras."""
        out = []
        spec = self.robot_spec
        link_counts: Dict[str, int] = {}
        for body_i, cols in enumerate(spec.body_collisions):
            for (link_name, ctype, size, p, q) in cols:
                idx_in_link = link_counts.get(link_name, 0)
                link_counts[link_name] = idx_in_link + 1
                keep = self.urdf_collision_filter.get(link_name)
                if keep is not None and idx_in_link not in keep:
                    continue
                out.append(dict(
                    link=spec.link_names[body_i], type=_GEOM_TYPE_BY_NAME[ctype],
                    size=np.resize(np.asarray(size, np.float32), 3),
                    offset_p=p, offset_q=q,
                    friction=self.link_friction.get(link_name, self.default_friction),
                ))
        for g in self.extra_collisions:
            g = dict(g)
            g.setdefault("friction",
                         self.link_friction.get(g["link"], self.default_friction))
            out.append(g)
        return out

    def install(self, builder: SceneSpecBuilder, base_pose: np.ndarray,
                init_qpos: Optional[np.ndarray] = None):
        """Add this robot, with the active control mode's drive gains."""
        if init_qpos is None and "rest" in self.keyframes:
            init_qpos = self.keyframes["rest"].qpos
        builder.add_robot(self.robot_spec, base_pose,
                          collision_geoms=self.collision_geoms(),
                          init_qpos=init_qpos,
                          balance_passive_force=self.balance_passive_force)
        c = self.controller
        builder.set_drive_properties(c.kp, c.kd, c.force_limit)

    def proprioception(self, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
        return dict(qpos=qpos, qvel=qvel)
