"""Scene model: static scene description + batched simulation state.

Port of ``maniskill_tpu/physics/model.py`` for the scene classes of
PickCube, StackCube, PickSingleHull/YCB, PlugCharger and RollBall (boxes,
planes, spheres, capsules, free bodies of one or several offset geoms, free
convex hulls; pairs resolved as in ``_build_pair_tables``, ``:336-373``):
``SimParams``, ``SimState`` (with the per-env hull tables, ``:164-169``),
``DriveCmd``, ``SceneModel`` (``hull_verts0``, ``hull_faces0``, ``n_hull``,
``geom_hull_slot``, ``:249-266``) and ``SceneSpecBuilder`` with
``box_geom``/``sphere_geom``/``capsule_geom``/``plane_geom`` (``:897-918``),
``add_free_hull`` (``:583-607``), ``exclude_pair`` (``:675``) and
articulated objects (``add_articulation``, ``:521``): ``build`` merges the
robot's tree and every object's tree into one kinematic forest
(``:713-777``, ``kinematics/articulation.merge_forest``), the object's
carcass a static body ``"<name>:base"`` at its pose, its link geoms
ROBOT_LINK geoms on the forest's bodies, its dofs passive (no drive), with a
gravity flag per body (``gravity_mask``), ``tree_id`` and
``art_dof_index``. Two robot-link geoms pair only across trees
(``:781-822``): the robot's fingers against a lid, never the robot against
itself. As in the JAX builder, two geoms of one free body form a pair too
(PlugCharger's two prongs: a ``capsule_capsule`` pair whose Jacobian
columns cancel). Not ported yet: actor-pair drives.

``SceneModel`` holds numpy constants (device-free). ``SimState`` and
``DriveCmd`` are dataclasses of tensors with the batch dimension K leading.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kinematics.urdf import RobotSpec, _pose_mul
from .hulls import HULL_F, HULL_P
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
    hull: int = -1  # slot into the per-env hull tables (gtype == HULL)


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


def tree_map(fn: Callable, obj, *rest):
    """Apply ``fn`` to every tensor in a nest of dataclasses and dicts, or
    to the matching tensors of several nests of one structure, as
    ``fn(leaf, *leaves)`` (dict entries matched by key; ``None`` fields stay
    ``None``, other leaves are taken from ``obj``). Nests that differ in
    their keys, their fields or where a field is ``None`` raise."""
    if obj is None:
        if any(o is not None for o in rest):
            raise ValueError("a field is None in one nest only")
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if isinstance(obj, dict):
        if any(not isinstance(o, dict) or o.keys() != obj.keys() for o in rest):
            raise ValueError(f"dicts with other keys than {sorted(obj)}")
        return {k: tree_map(fn, v, *(o[k] for o in rest)) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        if any(type(o) is not type(obj) for o in rest):
            raise ValueError(f"nests of other types than {type(obj).__name__}")
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name), *(getattr(o, f.name) for o in rest))
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
    # per-env convex-hull tables (each env may hold a different object)
    hull_verts: Optional[torch.Tensor] = None  # (K, n_hull, HULL_P, 3) contact cloud
    hull_faces: Optional[torch.Tensor] = None  # (K, n_hull, HULL_F, 4) planes [n, d]


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
        gravity_mask: Optional[np.ndarray] = None,  # (nb,)
        tree_id: Optional[np.ndarray] = None,  # (nb,)
        art_dof_index: Optional[Dict[str, np.ndarray]] = None,
        hull_verts: Optional[np.ndarray] = None,  # (n_hull, HULL_P, 3)
        hull_faces: Optional[np.ndarray] = None,  # (n_hull, HULL_F, 4)
    ):
        self.hull_verts0 = (hull_verts.astype(np.float32) if hull_verts is not None
                            else np.zeros((0, HULL_P, 3), np.float32))
        self.hull_faces0 = (hull_faces.astype(np.float32) if hull_faces is not None
                            else np.zeros((0, HULL_F, 4), np.float32))
        self.n_hull = self.hull_verts0.shape[0]
        # geom index -> hull slot (-1 for non-hull geoms)
        self.geom_hull_slot = np.array([g.hull for g in geoms], np.int32)
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
        # a gravity scale per body: the robot's links feel gravity only with
        # balance_passive_force off, an articulated object's links always
        self.gravity_mask = (gravity_mask.astype(np.float32) if gravity_mask is not None
                             else np.full(nb, 1.0 if robot_gravity else 0.0, np.float32))
        # the forest's tree of each body (0: the robot), and each articulated
        # object's dofs
        self.tree_id = tree_id if tree_id is not None else np.zeros(nb, np.int32)
        self.art_dof_index = art_dof_index or {}
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
            hull_verts=rep(self.hull_verts0),
            hull_faces=rep(self.hull_faces0),
        )

    def geom_indices(self, name: str):
        """Indices into the geom table (and ``SimState.geom_size`` rows) of
        the geoms of the named body."""
        return [i for i, g in enumerate(self.geoms) if g.name == name]


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
        self._excluded_pairs: set = set()
        self._excluded_groups: list = []
        # articulated objects: (name, spec, pose, base_geoms, link_geoms,
        # init_qpos)
        self._articulations: list = []
        # a robot that is itself a forest of several robots
        # (``agents/multi_agent.py``): the tree of each robot body
        self._forest_tree_id: Optional[np.ndarray] = None
        # per-env convex hull tables (one slot per HULL geom)
        self.hull_verts: List[np.ndarray] = []
        self.hull_faces: List[np.ndarray] = []

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

    def add_articulation(self, builder, pose: np.ndarray) -> str:
        """Add an articulated OBJECT built with
        ``kinematics.articulation.ArticulationBuilder``. ``build`` merges its
        tree into the scene's forest after the robot's; its dofs are passive
        (no drive gains) and its links feel gravity. Returns its name."""
        spec, base_geoms, link_geoms, init_q = builder.build()
        self._articulations.append((builder.name, spec, np.asarray(pose, np.float32),
                                    base_geoms, link_geoms, init_q))
        return builder.name

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

    def add_free_hull(self, name: str, asset, density: float = 1000.0,
                      friction: float = 0.3) -> int:
        """Free rigid body whose collision shape is a convex hull
        (``physics/hulls.py`` ``HullAsset``). Its contact cloud (``cpts``,
        HULL_P points) and face planes become per-env state, so a task can
        give each env its own object. Returns the free-body index."""
        idx = len(self.free_names)
        self.free_names.append(name)
        self.free_mass.append(asset.mass(density))
        self.free_inertia.append(asset.inertia(density))
        slot = len(self.hull_verts)
        self.hull_verts.append(asset.cpts)  # the contact cloud, not the vertices
        self.hull_faces.append(asset.faces)
        self.geoms.append(GeomSpec(
            kind=BodyKind.FREE, body=idx, gtype=GeomType.HULL,
            size=np.asarray(asset.aabb_half, np.float32),
            offset_p=np.zeros(3, np.float32),
            offset_q=np.array([1, 0, 0, 0], np.float32),
            friction=friction, name=name, hull=slot))
        self._collision_enabled.append(True)
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

    def exclude_pair(self, name_a: str, name_b: str):
        self._excluded_pairs.add(frozenset((name_a, name_b)))

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

    def _merge_articulations(self, geoms, collision_enabled):
        """The robot's tree and every articulated object's, merged into one
        forest (JAX ``build``, ``:713-777``). Appends the objects' carcass
        and link geoms; returns the forest's model arrays."""
        from ..kinematics.articulation import merge_forest

        robot = self.robot
        trees, grav = [], []
        init_parts, kp_parts, kd_parts, fl_parts = [], [], [], []
        if robot is not None:
            trees.append((robot, self.robot_base_pose))
            grav += [1.0 if self.robot_gravity else 0.0] * robot.nb
            base_pose = self.robot_base_pose
            init_parts.append(self.init_qpos)
            kp_parts.append(self.drive_kp)
            kd_parts.append(self.drive_kd)
            fl_parts.append(self.drive_force_limit)
        else:
            base_pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        art_dof_index = {}

        def geom(kind, body, g, name):
            geoms.append(GeomSpec(
                kind=kind, body=body, gtype=GeomType(g["type"]),
                size=np.asarray(g["size"], np.float32),
                offset_p=np.asarray(g.get("offset_p", np.zeros(3)), np.float32),
                offset_q=np.asarray(g.get("offset_q", [1, 0, 0, 0]), np.float32),
                friction=g.get("friction", 0.3), name=name))
            collision_enabled.append(g.get("collision", True))

        for (name, spec, pose, base_geoms, link_geoms, init_q) in self._articulations:
            off = sum(t[0].nb for t in trees)
            trees.append((spec, pose))
            grav += [1.0] * spec.nb
            art_dof_index[name] = np.arange(off, off + spec.nb)
            init_parts.append(init_q)
            kp_parts.append(np.zeros(spec.nb, np.float32))
            kd_parts.append(np.zeros(spec.nb, np.float32))
            fl_parts.append(np.full(spec.nb, 1e10, np.float32))
            # the carcass: a static body at the object's pose
            if base_geoms:
                self.static_names.append(f"{name}:base")
                self.static_pose.append(np.asarray(pose, np.float32))
                for g in base_geoms:
                    geom(BodyKind.STATIC, len(self.static_names) - 1, g, f"{name}:base")
            for li, lg in enumerate(link_geoms):
                for g in lg:
                    geom(BodyKind.ROBOT_LINK, off + li, g, spec.link_names[li])
        forest, tree_id, _ = merge_forest(trees, base_pose)
        return dict(
            robot=forest, robot_base_pose=base_pose, tree_id=tree_id,
            gravity_mask=np.asarray(grav, np.float32), art_dof_index=art_dof_index,
            init_qpos=np.concatenate([np.asarray(p, np.float32) for p in init_parts]),
            drive_kp=np.concatenate(kp_parts), drive_kd=np.concatenate(kd_parts),
            drive_force_limit=np.concatenate(fl_parts))

    def build(self) -> SceneModel:
        geoms = list(self.geoms)
        collision_enabled = list(self._collision_enabled)
        forest = dict(
            robot=self.robot, robot_base_pose=self.robot_base_pose, tree_id=None,
            gravity_mask=None, art_dof_index={},
            init_qpos=self.init_qpos if self.init_qpos is not None else np.zeros(0),
            drive_kp=self.drive_kp if self.drive_kp is not None else np.zeros(0),
            drive_kd=self.drive_kd if self.drive_kd is not None else np.zeros(0),
            drive_force_limit=(self.drive_force_limit if self.drive_force_limit is not None
                               else np.zeros(0)))
        if self._articulations:
            forest = self._merge_articulations(geoms, collision_enabled)
        tree_id = forest["tree_id"]
        robot_tree = self._forest_tree_id

        def tree_of(body: int) -> int:
            if body < 0:
                return 0
            t = int(tree_id[body]) if tree_id is not None else 0
            if t == 0 and robot_tree is not None and body < len(robot_tree):
                return -1 - int(robot_tree[body])  # a robot of a multi-robot forest
            return t

        fixed = (BodyKind.STATIC, BodyKind.KINEMATIC)
        pairs = []
        for i in range(len(geoms)):
            for j in range(i + 1, len(geoms)):
                gi, gj = geoms[i], geoms[j]
                if not (collision_enabled[i] and collision_enabled[j]):
                    continue
                if gi.kind in fixed and gj.kind in fixed:
                    continue
                if (gi.kind == BodyKind.ROBOT_LINK and gj.kind == BodyKind.ROBOT_LINK
                        and tree_of(gi.body) == tree_of(gj.body)):
                    continue  # same-tree self-collision is off; across trees it is on
                if frozenset((gi.name, gj.name)) in self._excluded_pairs:
                    continue
                if self._group_excluded(gi.name, gj.name):
                    continue
                # canonical order for contact_fn (lower gtype first)
                pairs.append((i, j) if gi.gtype <= gj.gtype else (j, i))
        return SceneModel(
            free_names=self.free_names,
            free_mass=np.asarray(self.free_mass, dtype=np.float32)
            if self.free_mass else np.zeros(0, dtype=np.float32),
            free_inertia=np.stack(self.free_inertia)
            if self.free_inertia else np.zeros((0, 3, 3), dtype=np.float32),
            kin_names=self.kin_names,
            static_names=self.static_names,
            static_pose=np.stack(self.static_pose)
            if self.static_pose else np.zeros((0, 7), dtype=np.float32),
            geoms=geoms,
            pairs=pairs,
            params=self.params,
            robot_gravity=self.robot_gravity,
            hull_verts=np.stack(self.hull_verts) if self.hull_verts else None,
            hull_faces=np.stack(self.hull_faces) if self.hull_faces else None,
            **forest,
        )


def box_geom(size, offset_p=(0, 0, 0), offset_q=(1, 0, 0, 0), friction=0.3,
             collision=True):
    return dict(type=GeomType.BOX, size=np.asarray(size), offset_p=offset_p,
                offset_q=offset_q, friction=friction, collision=collision)


def sphere_geom(radius, offset_p=(0, 0, 0), friction=0.3, collision=True):
    return dict(type=GeomType.SPHERE, size=np.array([radius, 0, 0]),
                offset_p=offset_p, friction=friction, collision=collision)


def capsule_geom(radius, half_length, offset_p=(0, 0, 0), offset_q=(1, 0, 0, 0),
                 friction=0.3, collision=True):
    """Capsule of radius ``radius`` around a segment of half length
    ``half_length`` along the geom's +z axis."""
    return dict(type=GeomType.CAPSULE, size=np.array([radius, half_length, 0]),
                offset_p=offset_p, offset_q=offset_q, friction=friction,
                collision=collision)


def plane_geom(friction=0.3, collision=True):
    return dict(type=GeomType.PLANE, size=np.zeros(3), friction=friction,
                collision=collision)
