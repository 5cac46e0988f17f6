"""Prebuilt scene builders; port of ``TableSceneBuilder`` from
``maniskill_tpu/envs/scene_builders.py`` (the Panda mounts only: ``panda``
and ``panda_wristcam``, whose rest qpos differs in joints 2 and 7 as in the
JAX table)."""
from __future__ import annotations

import numpy as np

from ..physics.model import SceneSpecBuilder, box_geom, plane_geom

TABLE_HEIGHT = 0.9196429


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
