"""PickSingleYCB-v1: PickSingleHull over the YCB hull library.

Port of ``maniskill_tpu/envs/tasks/ycb_variants.py`` (``PickSingleYCB-v1``,
``:51-66``, with ``_set_hull_library_on``, ``:40-48``). Each model row is
the convex hull of a YCB mesh where the mesh pack is on disk
(``utils/building.py`` ``YCB_DIR``), else the procedural stand-in of the
same position, so the env runs without the pack. The other tasks of that
module are not ported.
"""
from __future__ import annotations

from ...utils.building import ycb_or_procedural_library
from ..registration import register_env
from .pick_single_hull import PickSingleHullEnv, set_hull_library


@register_env("PickSingleYCB-v1", max_episode_steps=50)
class PickSingleYCBEnv(PickSingleHullEnv):
    """The scene is built with the procedural library's first object, as in
    the JAX package; the library tables are then swapped (same padded
    sizes) and each env draws its object from them at reset."""

    def __init__(self, *args, model_ids=None, **kwargs):
        super().__init__(*args, **kwargs)
        set_hull_library(self, ycb_or_procedural_library(model_ids))
