"""A scene built to hold ``sphere_hull`` and ``hull_hull`` in contact.

No registered task on the kernel path pairs a sphere or a second hull with
a hull, so this scene does, for checks of the physics step (the CPU parity
tests, the CUDA tests and ``chip_smoke.py``): the Panda at its rest pose
on a ground plane and, behind it, a stack of three free bodies, each
dropped from 1 mm over the one below, that come to rest on one another
under gravity: a box-shaped hull "slab" (half extents 6 x 6 x 2 cm) on the
ground (``plane_hull``), a smaller box-shaped hull "block" (2 cm half
extents) on the slab (``hull_hull``: the block's contact cloud against the
slab's face planes and the slab's against the block's), and a 2 cm sphere
on the block (``sphere_hull``). Each env moves the block and the sphere by
up to 1 cm and 5 mm in x and y, so their points meet the faces below them
at different places, never on an edge. The three are kept out of the
robot's pairs, which keeps the scene within the JAX kernel's hull budget
(``_hull_cost``) and its size envelope (P n_all <= 12,000), so the JAX
side can run it as it is.

``build_hull_stack`` takes the builder, the agent, ``make_hull`` and the
geom constructors as arguments, so that one function builds the same scene
from either package; ``hull_stack`` builds it with this package's and
returns the model, a batched state and a command holding the arm at rest.
"""
from __future__ import annotations

import numpy as np
import torch

SLAB_HALF = (0.06, 0.06, 0.02)
BLOCK_HALF = 0.02
SPHERE_R = 0.02
X0 = -0.5  # the stack's x, behind the robot
GAP = 1e-3  # each body starts this far over its support
DENSITY = 1000.0


def _box_points(hx, hy, hz):
    return np.array([[sx * hx, sy * hy, sz * hz]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])


def build_hull_stack(builder, agent, make_hull, sphere_geom, plane_geom):
    """Add the scene's robot, ground and three free bodies to ``builder``."""
    agent.install(builder, np.array([0, 0, 0, 1, 0, 0, 0], np.float32))
    builder.add_static_body("ground", np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                            [plane_geom(friction=0.6)])
    builder.add_free_hull("slab", make_hull("slab", _box_points(*SLAB_HALF)),
                          density=DENSITY, friction=0.6)
    builder.add_free_hull("block", make_hull("block", _box_points(*[BLOCK_HALF] * 3)),
                          density=DENSITY, friction=0.6)
    r = SPHERE_R
    m = DENSITY * 4.0 / 3.0 * np.pi * r ** 3
    builder.add_free_body("ball", m, 0.4 * m * r * r * np.eye(3),
                          [sphere_geom(r, friction=0.6)])
    builder.exclude_groups(["slab", "block", "ball"], ["robot:*"])


def hull_stack(K: int, device, seed: int = 0, settle_steps: int = 0):
    """``(model, sim, cmd)``: this package's model of the scene, K envs with
    their own shifts, the bodies 1 mm apart, and a command holding the
    arm. With ``settle_steps``, the state after that many sim steps of the
    plain step. (Started exactly at rest, zero depth with no load, the
    bodies fall for one substep first, and whether a point reads +-1e-9
    deep decides the step: a float64 step then leaves the float32 one's
    tolerances in every env. 1 mm apart they land within one control step,
    every contact loaded by its end.)"""
    from ..agents.robots.panda import Panda
    from .engine import make_step_fn
    from .hulls import make_hull
    from .model import DriveCmd, SceneSpecBuilder, plane_geom, sphere_geom

    b = SceneSpecBuilder()
    build_hull_stack(b, Panda(device=device), make_hull, sphere_geom, plane_geom)
    model = b.build()
    g = torch.Generator(device=device).manual_seed(seed)
    sim = model.initial_state(K, device)
    pose = sim.free_pose.clone()

    def shift(scale):
        return torch.cat([scale * (2 * torch.rand((K, 2), generator=g, device=device) - 1),
                          torch.zeros((K, 1), device=device)], 1)

    slab, block, ball = (model.free_index[n] for n in ("slab", "block", "ball"))
    up = torch.tensor([0.0, 0.0, 1.0], device=device)
    pose[:, slab, :3] = torch.tensor([X0, 0.0, 0.0], device=device) + (SLAB_HALF[2] + GAP) * up
    pose[:, block, :3] = pose[:, slab, :3] + shift(0.01) + (SLAB_HALF[2] + BLOCK_HALF + GAP) * up
    pose[:, ball, :3] = pose[:, block, :3] + shift(0.005) + (BLOCK_HALF + SPHERE_R + GAP) * up
    sim = sim.replace(free_pose=pose)
    zeros = torch.zeros_like(sim.qpos)
    cmd = DriveCmd(target_qpos=sim.qpos, target_qvel=zeros, qf=zeros)
    if settle_steps:
        sim = make_step_fn(model)(sim, cmd, settle_steps)
    return model, sim, cmd
