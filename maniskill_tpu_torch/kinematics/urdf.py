"""URDF parsing into a static kinematic tree spec.

A copy of ``maniskill_tpu/kinematics/urdf.py`` (pure numpy; the port keeps
its own copy so that it imports nothing of the JAX package), without
``float_base``, which PickCube does not use. It produces numpy arrays that
the physics and kinematics layers consume as static model data.

Design: fixed joints are **fused** — their child links' inertias are merged into
the parent movable body (parallel-axis transform), and the child link frames are
retained as named *frames* for FK queries (e.g. ``panda_hand_tcp``). This keeps
the dynamic tree minimal (one body per degree of freedom subtree) which is what
the batched Featherstone/CRBA pipeline wants.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

JOINT_FREE = -1  # root free joint (not produced by URDF; used for free bodies)
JOINT_REVOLUTE = 0
JOINT_PRISMATIC = 1


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """URDF extrinsic XYZ rpy -> wxyz quaternion (numpy, host-side)."""
    r, p, y = rpy
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _pose_mul(pa, qa, pb, qb):
    return pa + _quat_to_mat(qa) @ pb, _quat_mul(qa, qb)


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = np.fromstring(elem.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(elem.get("rpy", "0 0 0"), sep=" ")
    return xyz, _rpy_to_quat(rpy)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # 3x3 rotational inertia about the link origin, in the link frame
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # primitive collision geoms: list of (type_str, size(3,), p(3,), q(4,))
    collisions: list = field(default_factory=list)


@dataclass
class UrdfJoint:
    name: str
    jtype: str
    parent: str
    child: str
    origin_p: np.ndarray
    origin_q: np.ndarray
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = np.inf
    velocity: float = np.inf
    damping: float = 0.0
    friction: float = 0.0
    mimic: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclass
class RobotSpec:
    """Fused kinematic tree: ``nb`` movable bodies + a fixed base (index -1).

    Array layout (all numpy, consumed as static data by JAX code):
      parent[i]       index of parent movable body (-1 = base)
      joint_type[i]   JOINT_REVOLUTE / JOINT_PRISMATIC
      joint_pos[i,3], joint_quat[i,4]
                      transform from the parent *body* frame to this body's
                      joint frame (joint frame == body frame at q=0)
      axis[i,3]       joint axis in the body frame
      mass[i], com[i,3], inertia[i,3,3]
                      fused inertial properties in the body frame
      qlim[i,2], effort[i], vel_limit[i], joint_damping[i], joint_friction[i]
      frames          name -> (body_index, p, q) fixed frames (fused links),
                      body_index = -1 refers to the base
      link_index      name -> body index for movable links
      joint_names     URDF names of movable joints, in tree (dof) order
    """

    name: str
    nb: int
    parent: np.ndarray
    joint_type: np.ndarray
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    axis: np.ndarray
    mass: np.ndarray
    com: np.ndarray
    inertia: np.ndarray
    qlim: np.ndarray
    effort: np.ndarray
    vel_limit: np.ndarray
    joint_damping: np.ndarray
    joint_friction: np.ndarray
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]]
    link_index: Dict[str, int]
    joint_names: List[str]
    link_names: List[str]
    base_link: str = "base"
    # per-body primitive collisions (fused into body frames):
    # body_collisions[i] = list of (link_name, type_str, size, p, q);
    # base_collisions for geometry attached to the fixed base
    body_collisions: List[list] = field(default_factory=list)
    base_collisions: list = field(default_factory=list)
    # reflected rotor inertia added to M[k,k] (MJCF 'armature'; zero for URDF)
    armature: Optional[np.ndarray] = None
    # inertial properties fused into the FIXED base (meaningless while the
    # base is fixed; float_base() promotes them onto the floating root body)
    base_mass: float = 0.0
    base_com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    base_inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))

    def frame_of(self, name: str) -> Tuple[int, np.ndarray, np.ndarray]:
        """Return (body_idx, offset_p, offset_q) for a movable link or a fused
        fixed frame."""
        if name in self.link_index:
            return self.link_index[name], np.zeros(3), np.array([1.0, 0, 0, 0])
        return self.frames[name]


def parse_urdf(path: str, root_link: Optional[str] = None) -> RobotSpec:
    """Parse a URDF file into a fused :class:`RobotSpec`.

    Capability parity with the reference's URDF loading path
    (``mani_skill/utils/building/urdf_loader.py``): kinematic structure, joint
    limits/dynamics, inertial data, mimic joints. Visual/collision meshes are
    intentionally not loaded — collision is supplied as primitives by the agent
    layer (see ``maniskill_tpu/agents``).
    """
    tree = ET.parse(path)
    robot = tree.getroot()
    name = robot.get("name", os.path.basename(path))

    links: Dict[str, UrdfLink] = {}
    for link_el in robot.findall("link"):
        ln = UrdfLink(name=link_el.get("name"))
        inertial = link_el.find("inertial")
        if inertial is not None:
            p, q = _parse_origin(inertial.find("origin"))
            mass_el = inertial.find("mass")
            ln.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            in_el = inertial.find("inertia")
            if in_el is not None:
                ixx = float(in_el.get("ixx", 0)); iyy = float(in_el.get("iyy", 0))
                izz = float(in_el.get("izz", 0)); ixy = float(in_el.get("ixy", 0))
                ixz = float(in_el.get("ixz", 0)); iyz = float(in_el.get("iyz", 0))
                I_c = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            else:
                I_c = np.zeros((3, 3))
            R = _quat_to_mat(q)
            # rotate inertia into link frame, then parallel-axis to link origin
            I_rot = R @ I_c @ R.T
            c = p
            ln.com = c
            ln.inertia = I_rot + ln.mass * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
        # primitive collision shapes (meshes are skipped; the agent layer may
        # supply primitive approximations for mesh-only links)
        for col_el in link_el.findall("collision"):
            cp, cq = _parse_origin(col_el.find("origin"))
            geo = col_el.find("geometry")
            if geo is None:
                continue
            box = geo.find("box")
            sph = geo.find("sphere")
            cyl = geo.find("cylinder")
            cap = geo.find("capsule")
            if box is not None:
                size = np.fromstring(box.get("size"), sep=" ") / 2.0
                ln.collisions.append(("box", size, cp, cq))
            elif sph is not None:
                r = float(sph.get("radius"))
                ln.collisions.append(("sphere", np.array([r, 0, 0]), cp, cq))
            elif cap is not None:
                r = float(cap.get("radius"))
                hl = float(cap.get("length")) / 2.0
                ln.collisions.append(("capsule", np.array([r, hl, 0]), cp, cq))
            elif cyl is not None:
                # approximate cylinders as capsules of the same radius
                r = float(cyl.get("radius"))
                hl = max(float(cyl.get("length")) / 2.0 - r, 1e-4)
                ln.collisions.append(("capsule", np.array([r, hl, 0]), cp, cq))
        links[ln.name] = ln

    joints: List[UrdfJoint] = []
    child_of: Dict[str, UrdfJoint] = {}
    for j_el in robot.findall("joint"):
        p, q = _parse_origin(j_el.find("origin"))
        axis_el = j_el.find("axis")
        axis = (
            np.fromstring(axis_el.get("xyz"), sep=" ")
            if axis_el is not None
            else np.array([1.0, 0, 0])
        )
        nrm = np.linalg.norm(axis)
        if nrm > 0:
            axis = axis / nrm
        limit_el = j_el.find("limit")
        dyn_el = j_el.find("dynamics")
        mimic_el = j_el.find("mimic")
        j = UrdfJoint(
            name=j_el.get("name"),
            jtype=j_el.get("type"),
            parent=j_el.find("parent").get("link"),
            child=j_el.find("child").get("link"),
            origin_p=p,
            origin_q=q,
            axis=axis,
            lower=float(limit_el.get("lower", 0)) if limit_el is not None else 0.0,
            upper=float(limit_el.get("upper", 0)) if limit_el is not None else 0.0,
            effort=float(limit_el.get("effort", np.inf)) if limit_el is not None else np.inf,
            velocity=float(limit_el.get("velocity", np.inf)) if limit_el is not None else np.inf,
            damping=float(dyn_el.get("damping", 0)) if dyn_el is not None else 0.0,
            friction=float(dyn_el.get("friction", 0)) if dyn_el is not None else 0.0,
            mimic=mimic_el.get("joint") if mimic_el is not None else None,
            mimic_multiplier=float(mimic_el.get("multiplier", 1)) if mimic_el is not None else 1.0,
            mimic_offset=float(mimic_el.get("offset", 0)) if mimic_el is not None else 0.0,
        )
        if j.jtype == "continuous":
            j.jtype = "revolute"
            j.lower, j.upper = -2 * np.pi, 2 * np.pi
        joints.append(j)
        child_of[j.child] = j

    # find root link (no parent joint)
    if root_link is None:
        children = {j.child for j in joints}
        roots = [l for l in links if l not in children]
        if len(roots) != 1:
            raise ValueError(f"expected 1 root link, got {roots}")
        root_link = roots[0]

    # children adjacency
    kids: Dict[str, List[UrdfJoint]] = {l: [] for l in links}
    for j in joints:
        kids[j.parent].append(j)

    # Walk the tree. Movable joints create bodies; fixed joints fuse.
    body_names: List[str] = []
    joint_names: List[str] = []
    parent_idx: List[int] = []
    jtype_arr: List[int] = []
    jpos: List[np.ndarray] = []
    jquat: List[np.ndarray] = []
    jaxis: List[np.ndarray] = []
    qlim: List[Tuple[float, float]] = []
    effort: List[float] = []
    vel_limit: List[float] = []
    jdamp: List[float] = []
    jfric: List[float] = []
    mass: List[float] = []
    com: List[np.ndarray] = []
    inertia: List[np.ndarray] = []
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
    link_index: Dict[str, int] = {}
    body_collisions: List[list] = []
    base_collisions: list = []

    base_inertial = dict(mass=0.0, com=np.zeros(3), inertia=np.zeros((3, 3)))

    def fuse_into(body_i: int, link_name: str, off_p: np.ndarray, off_q: np.ndarray):
        """Accumulate link inertia into body ``body_i`` (or base if -1) and
        record its frame; recurse over fixed children; return movable children
        as (joint, cumulative offset) pairs."""
        ln = links[link_name]
        if body_i < 0 and ln.mass > 0:
            # record fixed-base inertials so float_base() can promote them
            R = _quat_to_mat(off_q)
            c_new = off_p + R @ ln.com
            I_new = R @ (ln.inertia - ln.mass * (np.dot(ln.com, ln.com) * np.eye(3) - np.outer(ln.com, ln.com))) @ R.T
            I_new = I_new + ln.mass * (np.dot(c_new, c_new) * np.eye(3) - np.outer(c_new, c_new))
            m_tot = base_inertial["mass"] + ln.mass
            base_inertial["com"] = (base_inertial["mass"] * base_inertial["com"] + ln.mass * c_new) / m_tot
            base_inertial["mass"] = m_tot
            base_inertial["inertia"] = base_inertial["inertia"] + I_new
        if body_i >= 0 and ln.mass > 0:
            R = _quat_to_mat(off_q)
            c_new = off_p + R @ ln.com
            I_new = R @ (ln.inertia - ln.mass * (np.dot(ln.com, ln.com) * np.eye(3) - np.outer(ln.com, ln.com))) @ R.T
            I_new = I_new + ln.mass * (np.dot(c_new, c_new) * np.eye(3) - np.outer(c_new, c_new))
            m_tot = mass[body_i] + ln.mass
            com[body_i] = (mass[body_i] * com[body_i] + ln.mass * c_new) / m_tot
            mass[body_i] = m_tot
            inertia[body_i] = inertia[body_i] + I_new
        # register every fused link as a frame — identity offsets included
        # (an eef link welded at its parent's origin must still resolve)
        frames[link_name] = (body_i, off_p.copy(), off_q.copy())
        for (ctype, csize, cp, cq) in ln.collisions:
            gp, gq = _pose_mul(off_p, off_q, cp, cq)
            entry = (link_name, ctype, csize, gp, gq)
            if body_i < 0:
                base_collisions.append(entry)
            else:
                body_collisions[body_i].append(entry)
        movable = []
        for j in kids[link_name]:
            jp, jq = _pose_mul(off_p, off_q, j.origin_p, j.origin_q)
            if j.jtype == "fixed":
                movable += fuse_into(body_i, j.child, jp, jq)
            else:
                movable.append((j, jp, jq, body_i))
        return movable

    # BFS from root
    pending = fuse_into(-1, root_link, np.zeros(3), np.array([1.0, 0, 0, 0]))
    while pending:
        j, jp, jq, par = pending.pop(0)
        i = len(body_names)
        body_names.append(j.child)
        joint_names.append(j.name)
        link_index[j.child] = i
        parent_idx.append(par)
        jtype_arr.append(JOINT_REVOLUTE if j.jtype == "revolute" else JOINT_PRISMATIC)
        jpos.append(jp)
        jquat.append(jq)
        jaxis.append(j.axis)
        qlim.append((j.lower, j.upper))
        effort.append(j.effort)
        vel_limit.append(j.velocity)
        jdamp.append(j.damping)
        jfric.append(j.friction)
        mass.append(0.0)
        com.append(np.zeros(3))
        inertia.append(np.zeros((3, 3)))
        body_collisions.append([])
        pending = fuse_into(i, j.child, np.zeros(3), np.array([1.0, 0, 0, 0])) + pending

    # re-sort so parents precede children (BFS above guarantees it except for
    # the prepend trick; verify)
    for i, p in enumerate(parent_idx):
        assert p < i, "tree not topologically sorted"

    nb = len(body_names)
    return RobotSpec(
        name=name,
        nb=nb,
        parent=np.array(parent_idx, dtype=np.int32),
        joint_type=np.array(jtype_arr, dtype=np.int32),
        joint_pos=np.stack(jpos).astype(np.float64),
        joint_quat=np.stack(jquat).astype(np.float64),
        axis=np.stack(jaxis).astype(np.float64),
        mass=np.array(mass, dtype=np.float64),
        com=np.stack(com).astype(np.float64),
        inertia=np.stack(inertia).astype(np.float64),
        qlim=np.array(qlim, dtype=np.float64),
        effort=np.array(effort, dtype=np.float64),
        vel_limit=np.array(vel_limit, dtype=np.float64),
        joint_damping=np.array(jdamp, dtype=np.float64),
        joint_friction=np.array(jfric, dtype=np.float64),
        frames=frames,
        link_index=link_index,
        joint_names=joint_names,
        link_names=body_names,
        base_link=root_link,
        body_collisions=body_collisions,
        base_collisions=base_collisions,
        base_mass=base_inertial["mass"],
        base_com=base_inertial["com"],
        base_inertia=base_inertial["inertia"],
    )

