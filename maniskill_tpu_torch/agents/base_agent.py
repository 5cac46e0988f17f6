"""Agent layer: robot descriptors, controller assembly, proprioception.

Port of ``maniskill_tpu/agents/base_agent.py`` (``install``,
``proprioception``, URDF primitive collisions, ``auto_capsule_collisions``
``:53-106``). A robot class declares its URDF, collision material
overrides, extra primitive collisions, keyframes and controller configs;
``install`` wires it into a ``SceneSpecBuilder``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kinematics.urdf import RobotSpec, parse_urdf
from ..physics.model import SceneSpecBuilder
from ..physics.shapes import GeomType
from .controllers.base import ControllerConfig, make_controller
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


def auto_capsule_collisions(spec, default_radius: float = 0.045, radius_map=None,
                            tip_length: float = 0.08, friction: float = 0.3) -> List[dict]:
    """Primitive collisions for a mesh-only URDF: one capsule per body from
    its origin to each child's joint anchor (the link's structural axis),
    a sphere where that segment has zero length, and a tip capsule of
    ``tip_length`` along +z for a leaf body. Massless bodies get none."""
    radius_map = radius_map or {}
    out = []
    children = {b: [] for b in range(spec.nb)}
    for b in range(spec.nb):
        par = int(spec.parent[b])
        if par >= 0:
            children[par].append(b)
    for b in range(spec.nb):
        if spec.mass[b] <= 1e-5:
            continue  # a massless synthetic frame
        name = spec.link_names[b]
        r = radius_map.get(name, default_radius)
        segs = [np.asarray(spec.joint_pos[c], np.float64) for c in children[b]]
        if not segs:
            segs = [np.array([0.0, 0.0, tip_length])]
        for seg in segs:
            L = float(np.linalg.norm(seg))
            if L < 1e-6:
                out.append(dict(link=name, type=GeomType.SPHERE,
                                size=np.array([r, 0, 0], np.float32),
                                offset_p=np.zeros(3, np.float32),
                                offset_q=np.array([1, 0, 0, 0], np.float32),
                                friction=friction))
                continue
            # the rotation taking +z onto the segment
            z = seg / L
            c = float(z[2])
            if c > 1 - 1e-9:
                q = np.array([1.0, 0, 0, 0])
            elif c < -1 + 1e-9:
                q = np.array([0.0, 1.0, 0, 0])
            else:
                ax = np.cross([0.0, 0.0, 1.0], z)
                s_ = np.sqrt((1 + c) * 2)
                q = np.array([s_ / 2, *(ax / s_)])
            out.append(dict(link=name, type=GeomType.CAPSULE,
                            size=np.array([r, max(L / 2 - r / 2, 0.01), 0], np.float32),
                            offset_p=(seg / 2).astype(np.float32),
                            offset_q=q.astype(np.float32), friction=friction))
    return out


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

    def __init__(self, device="cpu", control_mode: Optional[str] = None):
        self.robot_spec: RobotSpec = self._make_robot_spec()
        self.nq = self.robot_spec.nb
        cfgs = self._controller_configs()
        if control_mode is None:
            control_mode = next(iter(cfgs))
        if control_mode not in cfgs:
            raise KeyError(f"unknown control mode {control_mode!r}; available: {list(cfgs)}")
        self.control_mode = control_mode
        named = {}
        for name, cfg in cfgs[control_mode].items():
            cfg.joint_indices = self._resolve_joints(cfg.joint_names)
            named[name] = make_controller(cfg, self.robot_spec.qlim, device)
        self.controller = CompositeController(named, self.nq, device)

    def _make_robot_spec(self) -> RobotSpec:
        """The parsed URDF; a robot may override it (and set its keyframes
        from the spec)."""
        return parse_urdf(self.urdf_path)

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
