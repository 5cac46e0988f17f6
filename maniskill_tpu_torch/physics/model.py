"""Scene model: static scene description + batched simulation state.

Port of ``maniskill_tpu/physics/model.py`` for the scene class PickCube
and StackCube use (boxes, planes, free bodies; box-box pairs resolved as in
``_build_pair_tables``, ``:336-373``): ``SimParams``, ``SimState``,
``DriveCmd``, ``SceneModel`` and ``SceneSpecBuilder`` with
``box_geom``/``plane_geom``. Not ported yet: convex hulls, capsules and
spheres, articulated objects merged into a kinematic forest, and
actor-pair drives.

``SceneModel`` holds numpy constants (device-free). ``SimState`` and
``DriveCmd`` are dataclasses of tensors with the batch dimension K leading.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..kinematics.urdf import RobotSpec, _pose_mul
from .shapes import GeomType, box_box_corners, box_box_onesided, contact_fn


class BodyKind(IntEnum):
    STATIC = 0
    KINEMATIC = 1
    FREE = 2
    ROBOT_LINK = 3


@dataclass(frozen=True)
class GeomSpec:
    """One collision geometry, attached to a body."""

    kind: BodyKind
    body: int  # robot body index / free index / kin index / static index
    gtype: GeomType
    size: np.ndarray  # (3,)
    offset_p: np.ndarray  # (3,) local offset in body frame
    offset_q: np.ndarray  # (4,)
    friction: float = 0.3
    name: str = ""


@dataclass(frozen=True)
class SimParams:
    """Solver parameters; defaults and meaning as in the JAX package
    (``maniskill_tpu/physics/model.py:57``)."""

    dt: float = 0.01
    substeps: int = 1
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact_mode: str = "velocity"
    contact_beta: float = 0.2
    contact_bias_max: float = 10.0
    contact_relax: float = 0.5
    contact_stiffness: float = 5.0e4
    contact_ref_penetration: float = 1.0e-4
    contact_damping_ratio: float = 1.0
    friction_vreg: float = 0.002
    joint_limit_stiffness: float = 4.0e3
    joint_limit_damping: float = 1.0e2
    contact_margin: float = 0.01
    joint_friction_vreg: float = 0.02
    max_lin_vel: float = 25.0
    max_ang_vel: float = 50.0


def tree_map(fn: Callable, obj):
    """Apply ``fn`` to every tensor in a nest of dataclasses and dicts
    (``None`` fields stay ``None``)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def tree_cat(objs):
    """Concatenate matching nests of dataclasses and dicts leaf by leaf
    along the batch dimension (``None`` fields stay ``None``)."""
    first = objs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(objs)
    if isinstance(first, dict):
        return {k: tree_cat([o[k] for o in objs]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_cat([getattr(o, f.name) for o in objs])
            for f in dataclasses.fields(first)})
    return first


class _Struct:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class SimState(_Struct):
    """Batched simulation state (K leading); field meaning as in the JAX
    ``SimState``."""

    qpos: torch.Tensor  # (K, nq)
    qvel: torch.Tensor  # (K, nq)
    free_pose: torch.Tensor  # (K, n_free, 7) [p, q_wxyz]
    free_vel: torch.Tensor  # (K, n_free, 6) [lin_vel, ang_vel]
    kin_pose: torch.Tensor  # (K, n_kin, 7)
    geom_size: torch.Tensor  # (K, n_geoms, 3)
    contact_lam: torch.Tensor  # (K, P) warm-started normal impulses
    contact_lam_t: torch.Tensor  # (K, P, 3) warm-started friction
    free_mass: torch.Tensor  # (K, n_free)
    free_inertia: torch.Tensor  # (K, n_free, 3, 3) about CoM, body frame
    geom_pos: torch.Tensor  # (K, n_geoms, 3) geom-in-body offsets
    geom_quat: torch.Tensor  # (K, n_geoms, 4)


@dataclass
class DriveCmd(_Struct):
    """PD drive command (K leading)."""

    target_qpos: torch.Tensor  # (K, nq)
    target_qvel: torch.Tensor  # (K, nq)
    qf: torch.Tensor  # (K, nq) extra generalized force
    kp: Optional[torch.Tensor] = None  # (K, nq); None -> model gains
    kd: Optional[torch.Tensor] = None
    force_limit: Optional[torch.Tensor] = None


class SceneModel:
    """Static scene description; all array members are numpy constants."""

    def __init__(
        self,
        robot: Optional[RobotSpec],
        robot_base_pose: np.ndarray,
        free_names: List[str],
        free_mass: np.ndarray,
        free_inertia: np.ndarray,
        kin_names: List[str],
        static_names: List[str],
        static_pose: np.ndarray,
        geoms: List[GeomSpec],
        pairs: List[Tuple[int, int]],
        params: SimParams,
        drive_kp: np.ndarray,
        drive_kd: np.ndarray,
        drive_force_limit: np.ndarray,
        init_qpos: np.ndarray,
        robot_gravity: bool = False,
    ):
        self.robot = robot
        self.robot_base_pose = robot_base_pose.astype(np.float32)
        self.free_names = free_names
        self.free_mass = free_mass.astype(np.float32)
        self.free_inertia = free_inertia.astype(np.float32)
        self.kin_names = kin_names
        self.static_names = static_names
        self.static_pose = static_pose.astype(np.float32)
        self.geoms = geoms
        self.pairs = pairs
        self.params = params
        self.drive_kp = drive_kp.astype(np.float32)
        self.drive_kd = drive_kd.astype(np.float32)
        self.drive_force_limit = drive_force_limit.astype(np.float32)
        self.init_qpos = init_qpos.astype(np.float32)
        self.robot_gravity = robot_gravity
        nb = robot.nb if robot is not None else 0
        # robot links feel gravity only with balance_passive_force off
        self.gravity_mask = np.full(nb, 1.0 if robot_gravity else 0.0, np.float32)
        self.nq = nb
        self.n_free = len(free_names)
        self.n_kin = len(kin_names)
        self.free_index = {n: i for i, n in enumerate(free_names)}
        self.kin_index = {n: i for i, n in enumerate(kin_names)}

        if robot is not None:
            # anc[b, j] = 1 if dof j actuates body b
            anc = np.zeros((nb, nb), dtype=np.float32)
            for b in range(nb):
                j = b
                while j >= 0:
                    anc[b, j] = 1.0
                    j = int(robot.parent[j])
            self.ancestor_mask = anc
            # inertia about CoM in body frame (spec stores it about the origin)
            Ic = []
            for i in range(nb):
                c = robot.com[i]
                m = robot.mass[i]
                Ic.append(robot.inertia[i]
                          - m * (np.dot(c, c) * np.eye(3) - np.outer(c, c)))
            self.robot_inertia_com = np.stack(Ic).astype(np.float32)
            self.robot_qlim = robot.qlim.astype(np.float32)
        else:
            self.ancestor_mask = np.zeros((0, 0), dtype=np.float32)
            self.robot_inertia_com = np.zeros((0, 3, 3), dtype=np.float32)
            self.robot_qlim = np.zeros((0, 2), dtype=np.float32)
        self._build_pair_tables()

    def _build_pair_tables(self):
        """Resolve each pair's contact function and group pairs by function
        (groups ordered by function name, as in the JAX package). Box-box
        pairs: against a static or kinematic box the one-sided 8-point
        test (the dynamic box as side A), against a robot link the 16
        corners, free against free the full 28-point ``box_box``."""
        self.pair_table = []
        fixed = (BodyKind.STATIC, BodyKind.KINEMATIC)
        for (ia, ib) in self.pairs:
            ga, gb = self.geoms[ia], self.geoms[ib]
            fn, k, swapped = contact_fn(ga.gtype, gb.gtype)
            if ga.gtype == GeomType.BOX and gb.gtype == GeomType.BOX:
                if (ga.kind in fixed) != (gb.kind in fixed):
                    # only the dynamic box's corners can penetrate
                    if ga.kind in fixed:
                        ia, ib = ib, ia
                        ga, gb = gb, ga
                    fn, k = box_box_onesided, 8
                elif BodyKind.ROBOT_LINK in (ga.kind, gb.kind):
                    fn, k = box_box_corners, 16
            if swapped:
                ia, ib = ib, ia
            mu = 0.5 * (ga.friction + gb.friction)
            self.pair_table.append((ia, ib, fn, k, mu))
        by_fn = {}
        for (ia, ib, fn, k, mu) in self.pair_table:
            by_fn.setdefault(fn.__name__, (fn, k, []))[2].append((ia, ib, mu))
        self.pair_groups = []
        for fname in sorted(by_fn):
            fn, k, entries = by_fn[fname]
            self.pair_groups.append((
                fn, k,
                np.array([e[0] for e in entries], dtype=np.int32),
                np.array([e[1] for e in entries], dtype=np.int32),
                np.array([e[2] for e in entries], dtype=np.float32),
            ))
        self.n_points = sum(k * len(ia) for (_, k, ia, _, _) in self.pair_groups)

    def initial_state(self, batch: int = 1, device="cpu") -> SimState:
        """Batched zero state with the robot at ``init_qpos``."""
        G = len(self.geoms)

        def rep(a):
            t = torch.as_tensor(np.asarray(a, np.float32), device=device)
            return t.expand((batch,) + t.shape).clone()

        free_pose = np.zeros((self.n_free, 7), np.float32)
        free_pose[:, 3] = 1.0
        kin_pose = np.zeros((self.n_kin, 7), np.float32)
        kin_pose[:, 3] = 1.0
        return SimState(
            qpos=rep(self.init_qpos),
            qvel=rep(np.zeros(self.nq)),
            free_pose=rep(free_pose),
            free_vel=rep(np.zeros((self.n_free, 6))),
            kin_pose=rep(kin_pose),
            geom_size=rep(np.stack([g.size for g in self.geoms]) if G
                          else np.zeros((0, 3))),
            contact_lam=rep(np.zeros(self.n_points)),
            contact_lam_t=rep(np.zeros((self.n_points, 3))),
            free_mass=rep(self.free_mass),
            free_inertia=rep(self.free_inertia),
            geom_pos=rep(np.stack([g.offset_p for g in self.geoms]) if G
                         else np.zeros((0, 3))),
            geom_quat=rep(np.stack([g.offset_q for g in self.geoms]) if G
                          else np.zeros((0, 4))),
        )


class SceneSpecBuilder:
    """Imperative builder used by tasks to assemble a ``SceneModel``."""

    def __init__(self, params: SimParams = SimParams()):
        self.params = params
        self.robot: Optional[RobotSpec] = None
        self.robot_gravity = False
        self.robot_base_pose = np.array([0, 0, 0, 1, 0, 0, 0], dtype=np.float32)
        self.free_names: List[str] = []
        self.free_mass: List[float] = []
        self.free_inertia: List[np.ndarray] = []
        self.kin_names: List[str] = []
        self.static_names: List[str] = []
        self.static_pose: List[np.ndarray] = []
        self.geoms: List[GeomSpec] = []
        self._collision_enabled: List[bool] = []
        self.drive_kp = None
        self.drive_kd = None
        self.drive_force_limit = None
        self.init_qpos = None
        self._excluded_groups: list = []

    def _add_geoms(self, kind, idx, name, geoms):
        for g in geoms:
            self.geoms.append(GeomSpec(
                kind=kind, body=idx, gtype=GeomType(g["type"]),
                size=np.asarray(g["size"], dtype=np.float32),
                offset_p=np.asarray(g.get("offset_p", np.zeros(3)), np.float32),
                offset_q=np.asarray(g.get("offset_q", [1, 0, 0, 0]), np.float32),
                friction=g.get("friction", 0.3),
                name=name,
            ))
            self._collision_enabled.append(g.get("collision", True))

    def add_robot(self, spec: RobotSpec, base_pose: np.ndarray,
                  collision_geoms: List[dict],
                  init_qpos: Optional[np.ndarray] = None,
                  balance_passive_force: bool = True):
        """collision_geoms: dicts {link, type, size, offset_p, offset_q,
        friction}."""
        if self.robot is not None:
            raise ValueError("one robot per scene")
        self.robot = spec
        self.robot_gravity = not balance_passive_force
        self.robot_base_pose = np.asarray(base_pose, dtype=np.float32)
        for g in collision_geoms:
            link = g["link"]
            body_idx, fp, fq = spec.frame_of(link)
            off_p = np.asarray(g.get("offset_p", np.zeros(3)), dtype=np.float64)
            off_q = np.asarray(g.get("offset_q", [1, 0, 0, 0]), dtype=np.float64)
            p, q = _pose_mul(fp, fq, off_p, off_q)
            self.geoms.append(GeomSpec(
                kind=BodyKind.ROBOT_LINK, body=body_idx,
                gtype=GeomType(g["type"]),
                size=np.asarray(g["size"], dtype=np.float32),
                offset_p=p.astype(np.float32), offset_q=q.astype(np.float32),
                friction=g.get("friction", 0.3), name=f"robot:{link}",
            ))
            self._collision_enabled.append(True)
        self.init_qpos = (np.asarray(init_qpos, dtype=np.float32)
                          if init_qpos is not None
                          else np.zeros(spec.nb, dtype=np.float32))
        self.drive_kp = np.zeros(spec.nb, dtype=np.float32)
        self.drive_kd = np.zeros(spec.nb, dtype=np.float32)
        self.drive_force_limit = np.full(spec.nb, 1e10, dtype=np.float32)

    def set_drive_properties(self, kp, kd, force_limit):
        nb = self.robot.nb
        self.drive_kp = np.broadcast_to(np.asarray(kp, np.float32), (nb,)).copy()
        self.drive_kd = np.broadcast_to(np.asarray(kd, np.float32), (nb,)).copy()
        self.drive_force_limit = np.broadcast_to(
            np.asarray(force_limit, np.float32), (nb,)).copy()

    def add_free_body(self, name: str, mass: float, inertia: np.ndarray,
                      geoms: List[dict]) -> int:
        idx = len(self.free_names)
        self.free_names.append(name)
        self.free_mass.append(mass)
        self.free_inertia.append(np.asarray(inertia, dtype=np.float32))
        self._add_geoms(BodyKind.FREE, idx, name, geoms)
        return idx

    def add_kinematic_body(self, name: str, geoms: List[dict] = ()) -> int:
        idx = len(self.kin_names)
        self.kin_names.append(name)
        self._add_geoms(BodyKind.KINEMATIC, idx, name, geoms)
        return idx

    def add_static_body(self, name: str, pose: np.ndarray, geoms: List[dict]) -> int:
        idx = len(self.static_names)
        self.static_names.append(name)
        self.static_pose.append(np.asarray(pose, dtype=np.float32))
        self._add_geoms(BodyKind.STATIC, idx, name, geoms)
        return idx

    def exclude_groups(self, patterns_a, patterns_b):
        """Exclude pairs where one geom name matches a pattern in
        ``patterns_a`` (fnmatch) and the other one in ``patterns_b``."""
        self._excluded_groups.append((tuple(patterns_a), tuple(patterns_b)))

    def _group_excluded(self, name_a: str, name_b: str) -> bool:
        from fnmatch import fnmatch

        for (pats_a, pats_b) in self._excluded_groups:
            a_in_a = any(fnmatch(name_a, p) for p in pats_a)
            b_in_b = any(fnmatch(name_b, p) for p in pats_b)
            b_in_a = any(fnmatch(name_b, p) for p in pats_a)
            a_in_b = any(fnmatch(name_a, p) for p in pats_b)
            if (a_in_a and b_in_b) or (b_in_a and a_in_b):
                return True
        return False

    def build(self) -> SceneModel:
        fixed = (BodyKind.STATIC, BodyKind.KINEMATIC)
        pairs = []
        geoms = self.geoms
        for i in range(len(geoms)):
            for j in range(i + 1, len(geoms)):
                gi, gj = geoms[i], geoms[j]
                if not (self._collision_enabled[i] and self._collision_enabled[j]):
                    continue
                if gi.kind in fixed and gj.kind in fixed:
                    continue
                if gi.kind == BodyKind.ROBOT_LINK and gj.kind == BodyKind.ROBOT_LINK:
                    continue  # same-tree self-collision is off
                if self._group_excluded(gi.name, gj.name):
                    continue
                # canonical order for contact_fn (lower gtype first)
                pairs.append((i, j) if gi.gtype <= gj.gtype else (j, i))
        return SceneModel(
            robot=self.robot,
            robot_base_pose=self.robot_base_pose,
            free_names=self.free_names,
            free_mass=np.asarray(self.free_mass, dtype=np.float32)
            if self.free_mass else np.zeros(0, dtype=np.float32),
            free_inertia=np.stack(self.free_inertia)
            if self.free_inertia else np.zeros((0, 3, 3), dtype=np.float32),
            kin_names=self.kin_names,
            static_names=self.static_names,
            static_pose=np.stack(self.static_pose)
            if self.static_pose else np.zeros((0, 7), dtype=np.float32),
            geoms=list(geoms),
            pairs=pairs,
            params=self.params,
            drive_kp=self.drive_kp if self.drive_kp is not None else np.zeros(0),
            drive_kd=self.drive_kd if self.drive_kd is not None else np.zeros(0),
            drive_force_limit=self.drive_force_limit
            if self.drive_force_limit is not None else np.zeros(0),
            init_qpos=self.init_qpos if self.init_qpos is not None else np.zeros(0),
            robot_gravity=self.robot_gravity,
        )


def box_geom(size, offset_p=(0, 0, 0), offset_q=(1, 0, 0, 0), friction=0.3,
             collision=True):
    return dict(type=GeomType.BOX, size=np.asarray(size), offset_p=offset_p,
                offset_q=offset_q, friction=friction, collision=collision)


def plane_geom(friction=0.3, collision=True):
    return dict(type=GeomType.PLANE, size=np.zeros(3), friction=friction,
                collision=collision)
