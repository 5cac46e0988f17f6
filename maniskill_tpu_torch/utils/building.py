"""YCB mesh loader: real mesh assets -> padded convex hulls.

Port of ``maniskill_tpu/utils/building.py`` (``load_obj_vertices``,
``load_ycb_hull`` ``:57``, ``DEFAULT_YCB_IDS`` ``:74`` and
``ycb_or_procedural_library`` ``:81-96``) with the asset root of
``maniskill_tpu/utils/assets.py``. A dependency-free OBJ vertex reader and
``physics.hulls.make_hull`` turn a mesh into a ``HullAsset``; any model id
whose mesh is not on disk falls back to the procedural standard-object
library, so every task runs without the mesh pack. This module never
downloads anything.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..physics.hulls import HullAsset, make_hull, standard_object_library

# the asset tree the JAX package vendors, read by path as data files (as
# the Panda URDF is); MS_TPU_ASSET_DIR points at another tree
ASSET_DIR = Path(os.environ.get(
    "MS_TPU_ASSET_DIR", Path(__file__).resolve().parents[2] / "maniskill_tpu" / "assets"))
# where the YCB mesh pack would sit
YCB_DIR = os.environ.get(
    "MANISKILL_TPU_YCB_DIR", str(ASSET_DIR / "mani_skill2_ycb" / "models"))


def load_obj_vertices(path: str) -> np.ndarray:
    """Vertex positions (N, 3) of an OBJ file; normals, uvs and faces are
    ignored (contact needs the convex hull of the vertex set)."""
    verts: List[List[float]] = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError(f"no vertices in {path}")
    return np.asarray(verts, np.float64)


def _find_mesh(model_id: str) -> Optional[str]:
    base = os.path.join(YCB_DIR, model_id)
    for rel in ("collision.obj", "textured.obj", os.path.join("google_16k", "textured.obj")):
        p = os.path.join(base, rel)
        if os.path.exists(p):
            return p
    return None


def load_ycb_hull(model_id: str, scale: float = 1.0) -> HullAsset:
    """One YCB object as a padded ``HullAsset``; raises FileNotFoundError
    when its mesh is not under ``YCB_DIR`` (see
    :func:`ycb_or_procedural_library` for the fallback)."""
    mesh = _find_mesh(model_id)
    if mesh is None:
        raise FileNotFoundError(
            f"YCB model '{model_id}' not found under {YCB_DIR}; put the mesh pack "
            "there or use ycb_or_procedural_library()")
    return make_hull(model_id, load_obj_vertices(mesh) * scale)


# the reference PickSingleYCB episode list's most-used models
DEFAULT_YCB_IDS = [
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "008_pudding_box",
    "009_gelatin_box", "010_potted_meat_can",
]


def ycb_or_procedural_library(model_ids: Optional[List[str]] = None) -> List[HullAsset]:
    """HullAssets for the given YCB ids, with the procedural stand-in of the
    same position (``standard_object_library``, cycled) for any id whose
    mesh is missing: always one asset per id, so the per-env tables keep
    their sizes with or without the mesh pack."""
    ids = model_ids or DEFAULT_YCB_IDS
    procedural = standard_object_library()
    out: List[HullAsset] = []
    for i, mid in enumerate(ids):
        try:
            out.append(load_ycb_hull(mid))
        except (FileNotFoundError, ValueError):
            out.append(procedural[i % len(procedural)])
    return out
