"""Prebuilt scene builders and their registry; port of
``maniskill_tpu/envs/scene_builders.py``: ``TableSceneBuilder`` (the Panda
mounts only: ``panda`` and ``panda_wristcam``, whose rest qpos differs in
joints 2 and 7 as in the JAX table), ``KitchenCounterSceneBuilder`` (a
procedural counter of boxes) and ``REGISTERED_SCENE_BUILDERS``. The JAX
package's ``GroundSceneBuilder`` is not ported yet."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..physics.model import SceneSpecBuilder, box_geom, plane_geom

TABLE_HEIGHT = 0.9196429

REGISTERED_SCENE_BUILDERS: Dict[str, type] = {}


def register_scene_builder(name: str):
    def deco(cls):
        REGISTERED_SCENE_BUILDERS[name] = cls
        cls.name = name
        return cls

    return deco


@register_scene_builder("table")
class TableSceneBuilder:
    """Static table + ground and the robot's mount pose."""

    # world-frame table box after the reference's rot-z-90 placement
    TABLE_HALF = np.array([1.209 / 2, 2.418 / 2, TABLE_HEIGHT / 2], np.float32)
    TABLE_CENTER = np.array([-0.12, 0.0, -TABLE_HEIGHT / 2], np.float32)

    ROBOT_INIT = {
        "panda": dict(
            pose=np.array([-0.615, 0, 0, 1, 0, 0, 0], np.float32),
            qpos=np.array([0.0, -np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4,
                           np.pi / 4, 0.04, 0.04], np.float32),
        ),
        "panda_wristcam": dict(
            pose=np.array([-0.615, 0, 0, 1, 0, 0, 0], np.float32),
            qpos=np.array([0.0, np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4,
                           -np.pi / 4, 0.04, 0.04], np.float32),
        ),
    }

    def __init__(self, env):
        self.env = env

    def build(self, builder: SceneSpecBuilder):
        builder.add_static_body(
            "table-workspace",
            np.concatenate([self.TABLE_CENTER, [1, 0, 0, 0]]).astype(np.float32),
            [box_geom(self.TABLE_HALF)])
        builder.add_static_body(
            "ground", np.array([0, 0, -TABLE_HEIGHT, 1, 0, 0, 0], np.float32),
            [plane_geom()])
        # the floor is 0.92 m below the tabletop: the arm can never reach it
        builder.exclude_groups(["robot:*"], ["ground"])

    def robot_pose_and_qpos(self, robot_uid: str):
        cfg = self.ROBOT_INIT[robot_uid]
        return cfg["pose"], cfg["qpos"]


@register_scene_builder("kitchen_counter")
class KitchenCounterSceneBuilder:
    """Procedural kitchen counter: a worktop at z=0 (friction 0.6), the
    counter's body below it, a backsplash wall behind and the floor; the
    robot mounts as on the table."""

    COUNTER_HEIGHT = 0.92
    TOP_HALF = np.array([0.4, 1.0, 0.02], np.float32)

    def __init__(self, env):
        self.env = env

    def build(self, builder: SceneSpecBuilder):
        ch = self.COUNTER_HEIGHT
        builder.add_static_body(
            "counter-top", np.array([0.0, 0.0, -self.TOP_HALF[2], 1, 0, 0, 0], np.float32),
            [box_geom(self.TOP_HALF, friction=0.6)])
        builder.add_static_body(
            "counter-body", np.array([0.05, 0.0, -ch / 2, 1, 0, 0, 0], np.float32),
            [box_geom([0.35, 0.98, ch / 2 - 0.02])])
        builder.add_static_body(
            "backsplash", np.array([0.42, 0.0, 0.25, 1, 0, 0, 0], np.float32),
            [box_geom([0.02, 1.0, 0.3])])
        builder.add_static_body(
            "ground", np.array([0, 0, -ch, 1, 0, 0, 0], np.float32), [plane_geom()])
        builder.exclude_groups(["robot:*"], ["ground"])

    def robot_pose_and_qpos(self, robot_uid: str):
        cfg = TableSceneBuilder.ROBOT_INIT.get(robot_uid, TableSceneBuilder.ROBOT_INIT["panda"])
        return cfg["pose"], cfg["qpos"]
