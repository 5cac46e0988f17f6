"""Articulated objects built link by link, and the kinematic forest.

A copy of ``maniskill_tpu/kinematics/articulation.py`` (pure numpy; the port
keeps its own copy so that it imports nothing of the JAX package):
``ArticulationBuilder`` assembles an articulated OBJECT (a cabinet drawer, a
faucet handle, a suitcase lid) as a small ``RobotSpec`` tree plus collision
geom dicts, and ``merge_forest`` merges the robot's tree and every object's
tree into ONE forest ``RobotSpec`` with several roots, each root's joint
frame carrying its tree's base pose relative to the shared FK base. The
physics step's tree passes (FK, prefix and suffix sums, ancestor masks, the
mass matrix) take several roots as they are, so the objects' dofs share the
robot's contact solve (``SceneSpecBuilder.add_articulation``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE, RobotSpec, _pose_mul


def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]], dtype=np.float64)


def _rot(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * (w * np.cross(u, v) + np.cross(u, np.cross(u, v)))


def pose_inv(p, q):
    qi = _quat_conj(q)
    return -_rot(qi, np.asarray(p, np.float64)), qi


@dataclass
class _Link:
    name: str
    parent: int  # index into links; -1 = the articulation's fixed base
    joint_type: int
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    axis: np.ndarray
    mass: float
    com: np.ndarray
    inertia: np.ndarray
    qlim: Tuple[float, float]
    damping: float
    friction: float
    geoms: List[dict] = field(default_factory=list)


class ArticulationBuilder:
    """Build an articulated object link by link.

    Example (a drawer)::

        ab = ArticulationBuilder("cabinet")
        drawer = ab.add_prismatic_link(
            "drawer", parent=None, axis=(1, 0, 0), limits=(0.0, 0.3),
            joint_pose=((0, 0, 0.4), (1, 0, 0, 0)), mass=1.0, damping=5.0)
        ab.add_geom(drawer, box_geom([0.18, 0.18, 0.08]))
        spec, base_geoms, link_geoms, init_qpos = ab.build()
    """

    def __init__(self, name: str):
        self.name = name
        self.links: List[_Link] = []
        self.static_geoms: List[dict] = []  # fixed to the base
        self.init_qpos: List[float] = []

    def _add_link(self, name, parent, jtype, axis, limits, joint_pose, mass, com,
                  inertia, damping, friction, init_q) -> int:
        jp, jq = joint_pose
        if inertia is None:
            inertia = np.eye(3) * (mass * 0.01 + 1e-4)  # a box-ish default
        self.links.append(_Link(
            name=name, parent=-1 if parent is None else int(parent), joint_type=jtype,
            joint_pos=np.asarray(jp, np.float64), joint_quat=np.asarray(jq, np.float64),
            axis=np.asarray(axis, np.float64), mass=float(mass),
            com=np.asarray(com, np.float64), inertia=np.asarray(inertia, np.float64),
            qlim=(float(limits[0]), float(limits[1])), damping=float(damping),
            friction=float(friction)))
        self.init_qpos.append(float(init_q))
        return len(self.links) - 1

    def add_revolute_link(self, name, parent=None, axis=(0, 0, 1), limits=(-1.57, 1.57),
                          joint_pose=((0, 0, 0), (1, 0, 0, 0)), mass=1.0, com=(0, 0, 0),
                          inertia=None, damping=0.1, friction=0.0, init_q=0.0) -> int:
        return self._add_link(name, parent, JOINT_REVOLUTE, axis, limits, joint_pose, mass,
                              com, inertia, damping, friction, init_q)

    def add_prismatic_link(self, name, parent=None, axis=(1, 0, 0), limits=(0.0, 0.3),
                           joint_pose=((0, 0, 0), (1, 0, 0, 0)), mass=1.0, com=(0, 0, 0),
                           inertia=None, damping=0.1, friction=0.0, init_q=0.0) -> int:
        return self._add_link(name, parent, JOINT_PRISMATIC, axis, limits, joint_pose, mass,
                              com, inertia, damping, friction, init_q)

    def add_geom(self, link: int, geom: dict):
        self.links[link].geoms.append(geom)

    def add_base_geom(self, geom: dict):
        """Collision geometry fixed to the articulation's base (a cabinet's
        carcass around its drawer)."""
        self.static_geoms.append(geom)

    def build(self):
        """``(RobotSpec tree, base_geoms, link_geoms, init_qpos)``;
        ``link_geoms[i]`` is the geom dicts of movable link i, and names in
        the spec are ``{articulation}:{link}``."""
        nb = len(self.links)
        frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
        link_index: Dict[str, int] = {}
        for i, link in enumerate(self.links):
            full = f"{self.name}:{link.name}"
            link_index[full] = i
            frames[full] = (i, np.zeros(3), np.array([1.0, 0, 0, 0]))
        spec = RobotSpec(
            name=self.name,
            nb=nb,
            parent=np.array([link.parent for link in self.links], np.int32),
            joint_type=np.array([link.joint_type for link in self.links], np.int32),
            joint_pos=np.stack([link.joint_pos for link in self.links]),
            joint_quat=np.stack([link.joint_quat for link in self.links]),
            axis=np.stack([link.axis for link in self.links]),
            mass=np.array([link.mass for link in self.links]),
            com=np.stack([link.com for link in self.links]),
            # the spec stores inertia about the body ORIGIN (the model
            # converts it back to the centre of mass)
            inertia=np.stack([link.inertia + link.mass * (np.dot(link.com, link.com) * np.eye(3)
                                                          - np.outer(link.com, link.com))
                              for link in self.links]),
            qlim=np.array([link.qlim for link in self.links]),
            effort=np.full(nb, 1e3),
            vel_limit=np.full(nb, 1e3),
            joint_damping=np.array([link.damping for link in self.links]),
            joint_friction=np.array([link.friction for link in self.links]),
            frames=frames,
            link_index=link_index,
            joint_names=[f"{self.name}:{link.name}_joint" for link in self.links],
            link_names=[f"{self.name}:{link.name}" for link in self.links],
            base_link=f"{self.name}:base",
        )
        return (spec, list(self.static_geoms), [list(link.geoms) for link in self.links],
                np.asarray(self.init_qpos, np.float32))


def merge_forest(trees: List[Tuple[RobotSpec, np.ndarray]], base_pose: np.ndarray
                 ) -> Tuple[RobotSpec, np.ndarray, np.ndarray]:
    """Merge ``(spec, world_base_pose)`` trees into ONE forest ``RobotSpec``
    whose roots carry their tree's base offset relative to ``base_pose``
    (the shared FK base). Returns ``(forest, tree_id (nb,), dof offset of
    each tree)``."""
    inv_p, inv_q = pose_inv(np.asarray(base_pose[:3], np.float64),
                            np.asarray(base_pose[3:7], np.float64))
    fields = dict(parent=[], joint_type=[], joint_pos=[], joint_quat=[], axis=[], mass=[],
                  com=[], inertia=[], qlim=[], effort=[], vel_limit=[], joint_damping=[],
                  joint_friction=[])
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
    link_index: Dict[str, int] = {}
    joint_names: List[str] = []
    link_names: List[str] = []
    tree_id, dof_offsets = [], []
    off = 0
    for t, (spec, pose) in enumerate(trees):
        dof_offsets.append(off)
        rel_p, rel_q = _pose_mul(inv_p, inv_q, np.asarray(pose[:3], np.float64),
                                 np.asarray(pose[3:7], np.float64))
        for i in range(spec.nb):
            par = int(spec.parent[i])
            fields["parent"].append(off + par if par >= 0 else -1)
            fields["joint_type"].append(int(spec.joint_type[i]))
            jp = np.asarray(spec.joint_pos[i], np.float64)
            jq = np.asarray(spec.joint_quat[i], np.float64)
            if par < 0:
                jp, jq = _pose_mul(rel_p, rel_q, jp, jq)
            fields["joint_pos"].append(jp)
            fields["joint_quat"].append(jq)
            for name in ("axis", "mass", "com", "inertia", "qlim", "effort", "vel_limit",
                         "joint_damping", "joint_friction"):
                fields[name].append(getattr(spec, name)[i])
            tree_id.append(t)
        for name, (bi, fp, fq) in spec.frames.items():
            if bi < 0 and t > 0:
                # a fixed frame on a later tree's base: bake its world offset
                fp2, fq2 = _pose_mul(rel_p, rel_q, np.asarray(fp, np.float64),
                                     np.asarray(fq, np.float64))
                frames[name] = (-1, fp2, fq2)
            else:
                frames[name] = (bi + off if bi >= 0 else -1, fp, fq)
        for name, bi in spec.link_index.items():
            link_index[name] = bi + off
        joint_names += list(spec.joint_names)
        link_names += list(spec.link_names)
        off += spec.nb

    forest = RobotSpec(
        name="+".join(s.name for s, _ in trees),
        nb=off,
        parent=np.asarray(fields["parent"], np.int32),
        joint_type=np.asarray(fields["joint_type"], np.int32),
        joint_pos=np.stack(fields["joint_pos"]),
        joint_quat=np.stack(fields["joint_quat"]),
        axis=np.stack(fields["axis"]),
        mass=np.asarray(fields["mass"]),
        com=np.stack(fields["com"]),
        inertia=np.stack(fields["inertia"]),
        qlim=np.stack(fields["qlim"]),
        effort=np.asarray(fields["effort"]),
        vel_limit=np.asarray(fields["vel_limit"]),
        joint_damping=np.asarray(fields["joint_damping"]),
        joint_friction=np.asarray(fields["joint_friction"]),
        frames=frames,
        link_index=link_index,
        joint_names=joint_names,
        link_names=link_names,
        base_link=trees[0][0].base_link,
    )
    return forest, np.asarray(tree_id, np.int32), np.asarray(dof_offsets)
