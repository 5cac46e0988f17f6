"""MJCF (MuJoCo XML) model loader.

A copy of ``maniskill_tpu/kinematics/mjcf.py`` (pure numpy; the port keeps
its own copy so that it imports nothing of the JAX package): parses the
dm_control-style MJCF files of the control suite (hopper, ant, humanoid)
into the fused-tree :class:`~maniskill_tpu_torch.kinematics.urdf.RobotSpec`
the URDF path produces.

Supported subset (what the control-suite files exercise):
  * ``<default>`` class trees with joint/geom defaults + ``childclass``
  * bodies with multiple joints (expanded into chained single-dof frames
    through zero-mass intermediates: the engine is one dof per body)
  * ``<freejoint>`` expanded to 3 slides + 3 hinges (x, y, z + z, y, x
    euler chain; adequate for locomotion roots, with the gimbal caveat)
  * hinge / slide / fixed (welded) joints, degrees-by-default angles
  * capsule (``fromto`` or pos+size), sphere, box, plane geoms; mass and
    rotational inertia from geom volume x density (mujoco semantics)
  * ``<motor>`` actuators (joint + gear + ctrlrange)

Not parsed (irrelevant to physics): assets, materials, lights, cameras,
sites, sensors, tendons, joint stiffness.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .urdf import (
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    RobotSpec,
    _pose_mul,
    _quat_mul,
    _quat_to_mat,
)

_DEG = np.pi / 180.0


def _fromstr(s, n=None, default=None):
    if s is None:
        return default
    v = np.fromstring(s, sep=" ")
    if n is not None and v.size == 1:
        v = np.full(n, v[0])
    return v


def _quat_from_zaxis(z):
    """Quaternion rotating +z onto unit vector z."""
    z = z / np.linalg.norm(z)
    a = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(a, z))
    if c > 1 - 1e-10:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-10:
        return np.array([0.0, 1.0, 0, 0])  # 180° about x
    ax = np.cross(a, z)
    s = np.sqrt((1 + c) * 2)
    return np.array([s / 2, ax[0] / s, ax[1] / s, ax[2] / s])


def _euler_to_quat(e):
    """MJCF default eulerseq xyz (extrinsic), degrees already converted."""
    q = np.array([1.0, 0, 0, 0])
    for ang, ax in zip(e, [(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
        h = 0.5 * ang
        qa = np.array(
            [np.cos(h), *(np.sin(h) * np.asarray(ax, float))]
        )
        q = _quat_mul(qa, q)  # extrinsic: world-axis pre-multiply
    return q


def _geom_mass_inertia(g: dict):
    """(mass, com(3), I_com(3,3)) of one geom dict in geom-local frame,
    then transported to the body frame by offset pose."""
    rho = g["density"]
    t = g["type"]
    size = g["size"]
    if t == "sphere":
        r = size[0]
        m = rho * 4.0 / 3.0 * np.pi * r**3
        I = np.eye(3) * (0.4 * m * r * r)
    elif t == "capsule":
        r, h = size[0], size[1]  # radius, HALF length of cylinder part
        mc = rho * np.pi * r * r * (2 * h)
        ms = rho * 4.0 / 3.0 * np.pi * r**3
        # cylinder about its center
        Iz = 0.5 * mc * r * r
        Ix = mc * (r * r / 4.0 + h * h / 3.0)
        # two hemispheres (sphere split at h offsets)
        Iz += 0.4 * ms * r * r
        Ix += 0.4 * ms * r * r + ms * (h * h + 2 * h * (3.0 / 8.0 * r))
        m = mc + ms
        I = np.diag([Ix, Ix, Iz])
    elif t == "box":
        a, b, c = size
        m = rho * 8.0 * a * b * c
        I = (
            np.diag([b * b + c * c, a * a + c * c, a * a + b * b]) * m / 3.0
        )
    else:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    # rotate into body frame + parallel axis to body origin
    R = _quat_to_mat(g["offset_q"])
    I_b = R @ I @ R.T
    c = np.asarray(g["offset_p"], float)
    I_o = I_b + m * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
    return m, c, I_o


@dataclass
class MJCFModel:
    spec: RobotSpec
    collision_geoms: List[dict]  # agent-style dicts with 'link' keys
    world_geoms: List[dict]  # planes/static geoms from worldbody
    actuators: List[dict]  # {joint, gear, ctrlrange, dof}
    free_root_dofs: List[int]  # dof indices synthesized for root joints


class _Defaults:
    def __init__(self, parent=None):
        self.joint: Dict[str, str] = dict(parent.joint) if parent else {}
        self.geom: Dict[str, str] = dict(parent.geom) if parent else {}
        self.motor: Dict[str, str] = dict(parent.motor) if parent else {}
        self.children: Dict[str, "_Defaults"] = {}


def _parse_defaults(elem, parent=None) -> _Defaults:
    d = _Defaults(parent)
    for child in elem:
        if child.tag == "joint":
            d.joint.update(child.attrib)
        elif child.tag == "geom":
            d.geom.update(child.attrib)
        elif child.tag == "motor":
            d.motor.update(child.attrib)
        elif child.tag == "default":
            d.children[child.get("class")] = _parse_defaults(child, d)
    return d


def _lookup(defaults: _Defaults, cls: Optional[str]) -> _Defaults:
    if cls is None:
        return defaults

    def find(d):
        if cls in d.children:
            return d.children[cls]
        for c in d.children.values():
            r = find(c)
            if r is not None:
                return r
        return None

    return find(defaults) or defaults


def load_mjcf(path: str, root_prefix: str = "") -> MJCFModel:
    tree = ET.parse(path)
    root = tree.getroot()
    defaults = _Defaults()
    for d in root.findall("default"):
        defaults = _parse_defaults(d, defaults)
    gdefaults = defaults  # class names resolve against the GLOBAL tree

    # angle units: mujoco default is degrees unless compiler angle="radian"
    comp = root.find("compiler")
    angle_scale = _DEG
    if comp is not None and comp.get("angle") == "radian":
        angle_scale = 1.0

    bodies: List[dict] = []  # flat tree in our engine layout
    world_geoms: List[dict] = []
    name_to_body: Dict[str, int] = {}

    def geom_dict(elem, dcls: _Defaults):
        a = dict(dcls.geom)
        a.update(elem.attrib)
        gtype = a.get("type", "sphere")
        if gtype == "plane":
            return dict(type="plane", size=np.zeros(3),
                        offset_p=_fromstr(a.get("pos"), default=np.zeros(3)),
                        offset_q=np.array([1.0, 0, 0, 0]),
                        friction=_fromstr(a.get("friction"), default=np.array([1.0]))[0],
                        density=0.0, name=a.get("name", ""))
        density = float(a.get("density", 1000.0))
        fric = _fromstr(a.get("friction"), default=np.array([1.0]))[0]
        if "fromto" in a:
            ft = _fromstr(a["fromto"])
            p1, p2 = ft[:3], ft[3:]
            center = 0.5 * (p1 + p2)
            d = p2 - p1
            L = np.linalg.norm(d)
            q = _quat_from_zaxis(d / max(L, 1e-9))
            r = _fromstr(a.get("size"))[0]
            return dict(type=gtype, size=np.array([r, L / 2, 0.0]),
                        offset_p=center, offset_q=q, friction=fric,
                        density=density, name=a.get("name", ""))
        size = _fromstr(a.get("size"), default=np.array([0.05]))
        pos = _fromstr(a.get("pos"), default=np.zeros(3))
        if a.get("euler") is not None:
            q = _euler_to_quat(_fromstr(a["euler"]) * angle_scale)
        elif a.get("quat") is not None:
            q = _fromstr(a["quat"])
        else:
            q = np.array([1.0, 0, 0, 0])
        if gtype == "sphere":
            size = np.array([size[0], 0.0, 0.0])
        elif gtype == "capsule":
            size = np.array([size[0], size[1], 0.0])
        elif gtype == "box":
            size = np.asarray(size[:3])
        return dict(type=gtype, size=size, offset_p=pos, offset_q=q,
                    friction=fric, density=density, name=a.get("name", ""))

    def joint_list(body_elem, dcls):
        out = []
        if body_elem.find("freejoint") is not None:
            fj = body_elem.find("freejoint")
            for ax, jt in [((1, 0, 0), "slide"), ((0, 1, 0), "slide"),
                           ((0, 0, 1), "slide"), ((0, 0, 1), "hinge"),
                           ((0, 1, 0), "hinge"), ((1, 0, 0), "hinge")]:
                out.append(dict(name=f"{fj.get('name', 'root')}_{jt}_"
                                     f"{ax.index(1)}",
                                type=jt, axis=np.asarray(ax, float),
                                pos=np.zeros(3), limited=False,
                                range=(0.0, 0.0), damping=0.0, armature=0.0,
                                friction=0.0, free=True))
            return out
        for j in body_elem.findall("joint"):
            a = dict(_lookup(gdefaults, j.get("class")).joint
                     if j.get("class") else dcls.joint)
            a.update(j.attrib)
            jt = a.get("type", "hinge")
            if jt == "fixed":  # reference control XMLs use this extension
                continue
            limited = a.get("limited", "false") in ("true", "1")
            rng = _fromstr(a.get("range"), default=np.zeros(2))
            if jt == "hinge":
                rng = rng * angle_scale
            if a.get("range") is not None and a.get("limited") is None:
                limited = True
            out.append(dict(
                name=a.get("name", f"j{len(out)}"),
                type=jt,
                axis=_fromstr(a.get("axis"), default=np.array([0, 0, 1.0])),
                pos=_fromstr(a.get("pos"), default=np.zeros(3)),
                limited=limited, range=(float(rng[0]), float(rng[1])),
                damping=float(a.get("damping", 0.0)),
                armature=float(a.get("armature", 0.0)),
                friction=float(a.get("frictionloss", 0.0)),
                free=False,
            ))
        return out

    def walk(elem, parent_idx, dcls, weld_pose):
        """parent_idx: engine body index of the parent movable body (-1 =
        world); weld_pose: accumulated fixed transform from that movable
        parent's frame to this element's parent frame."""
        for body_elem in elem.findall("body"):
            cls = body_elem.get("childclass")
            bd = _lookup(gdefaults, cls) if cls else dcls
            pos = _fromstr(body_elem.get("pos"), default=np.zeros(3))
            if body_elem.get("euler") is not None:
                q = _euler_to_quat(
                    _fromstr(body_elem.get("euler")) * angle_scale)
            elif body_elem.get("quat") is not None:
                q = _fromstr(body_elem.get("quat"))
            else:
                q = np.array([1.0, 0, 0, 0])
            bp, bq = _pose_mul(weld_pose[0], weld_pose[1], pos, q)
            joints = joint_list(body_elem, bd)
            geoms = [geom_dict(g, bd) for g in body_elem.findall("geom")]
            name = root_prefix + body_elem.get(
                "name", f"body{len(bodies)}")
            if not joints:
                # welded body: fuse geoms into the movable parent
                if parent_idx >= 0:
                    for g in geoms:
                        gp, gq = _pose_mul(bp, bq, g["offset_p"],
                                           g["offset_q"])
                        g2 = dict(g)
                        g2["offset_p"], g2["offset_q"] = gp, gq
                        bodies[parent_idx]["geoms"].append(g2)
                    bodies[parent_idx]["frames"][name] = (bp, bq)
                else:
                    for g in geoms:
                        gp, gq = _pose_mul(bp, bq, g["offset_p"],
                                           g["offset_q"])
                        g2 = dict(g)
                        g2["offset_p"], g2["offset_q"] = gp, gq
                        world_geoms.append(g2)
                walk(body_elem, parent_idx, bd, (bp, bq))
                continue
            # chain of joints -> intermediate zero-mass frames; mujoco
            # applies joints innermost-LAST in its kinematics, but for
            # joints at a common point the chain order below (file order)
            # matches dm_control's dof ordering
            cur_parent = parent_idx
            cur_pose = (bp, bq)
            for kj, j in enumerate(joints):
                last = kj == len(joints) - 1
                # shift the frame so the joint pivot is the body origin
                jp, jq = _pose_mul(cur_pose[0], cur_pose[1], j["pos"],
                                   np.array([1.0, 0, 0, 0]))
                bodies.append(dict(
                    name=name if last else f"{name}__dof{kj}",
                    parent=cur_parent,
                    joint_name=root_prefix + j["name"],
                    joint_type=(JOINT_REVOLUTE if j["type"] == "hinge"
                                else JOINT_PRISMATIC),
                    joint_pos=jp, joint_quat=jq,
                    axis=j["axis"] / max(np.linalg.norm(j["axis"]), 1e-9),
                    qlim=(j["range"] if j["limited"]
                          else (-1e6, 1e6)),
                    damping=j["damping"], armature=j["armature"],
                    friction=j["friction"],
                    geoms=[] if not last else [
                        # geoms were specified in the ORIGINAL body frame;
                        # the final frame sits at the last joint pivot
                        dict(g, offset_p=g["offset_p"] - j["pos"])
                        for g in geoms
                    ],
                    frames={},
                ))
                cur_parent = len(bodies) - 1
                cur_pose = (np.zeros(3), np.array([1.0, 0, 0, 0]))
            name_to_body[name] = cur_parent
            walk(body_elem, cur_parent, bd,
                 (np.zeros(3), np.array([1.0, 0, 0, 0])))

    world = root.find("worldbody")
    for g in world.findall("geom"):
        world_geoms.append(geom_dict(g, defaults))
    walk(world, -1, defaults, (np.zeros(3), np.array([1.0, 0, 0, 0])))

    nb = len(bodies)
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    coll_geoms = []
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
    link_index: Dict[str, int] = {}
    for i, b in enumerate(bodies):
        ms, cs, Is = 0.0, np.zeros(3), np.zeros((3, 3))
        for g in b["geoms"]:
            m, c, I_o = _geom_mass_inertia(g)
            ms += m
            cs += m * c
            Is += I_o
            if g["type"] != "plane":
                coll_geoms.append(dict(
                    link=b["name"], type={"sphere": 1, "box": 2,
                                          "capsule": 3}[g["type"]],
                    size=np.asarray(g["size"], np.float32),
                    offset_p=np.asarray(g["offset_p"], np.float32),
                    offset_q=np.asarray(g["offset_q"], np.float32),
                    friction=g["friction"],
                ))
        # zero-mass chain intermediates get a tiny regularizing mass
        mass[i] = max(ms, 1e-6)
        com[i] = cs / ms if ms > 0 else np.zeros(3)
        inertia[i] = Is if ms > 0 else np.eye(3) * 1e-8
        link_index[b["name"]] = i
        frames[b["name"]] = (i, np.zeros(3), np.array([1.0, 0, 0, 0]))
        for fname, (fp, fq) in b["frames"].items():
            # welded frames carry real offsets: keep them OUT of link_index
            # (frame_of prefers link_index, which implies a zero offset)
            frames[fname] = (i, fp, fq)

    spec = RobotSpec(
        name=root.get("model", "mjcf"),
        nb=nb,
        parent=np.array([b["parent"] for b in bodies], np.int32),
        joint_type=np.array([b["joint_type"] for b in bodies], np.int32),
        joint_pos=np.stack([b["joint_pos"] for b in bodies]),
        joint_quat=np.stack([b["joint_quat"] for b in bodies]),
        axis=np.stack([b["axis"] for b in bodies]),
        mass=mass,
        com=com,
        inertia=inertia,
        qlim=np.array([b["qlim"] for b in bodies]),
        effort=np.full(nb, 1e3),
        vel_limit=np.full(nb, 1e3),
        joint_damping=np.array([b["damping"] for b in bodies]),
        joint_friction=np.array([b["friction"] for b in bodies]),
        frames=frames,
        link_index=link_index,
        joint_names=[b["joint_name"] for b in bodies],
        link_names=[b["name"] for b in bodies],
        base_link="world",
        armature=np.array([b["armature"] for b in bodies]),
    )

    jname_to_dof = {b["joint_name"]: i for i, b in enumerate(bodies)}
    actuators = []
    act = root.find("actuator")
    if act is not None:
        for m in act.findall("motor"):
            a = dict(defaults.motor)
            a.update(m.attrib)
            jn = root_prefix + a["joint"]
            cr = _fromstr(a.get("ctrlrange"), default=np.array([-1.0, 1.0]))
            actuators.append(dict(
                joint=jn, dof=jname_to_dof[jn],
                gear=float(a.get("gear", 1.0)),
                ctrlrange=(float(cr[0]), float(cr[1])),
            ))
    return MJCFModel(
        spec=spec,
        collision_geoms=coll_geoms,
        world_geoms=world_geoms,
        actuators=actuators,
        free_root_dofs=[],
    )
