"""DrawTriangle-v1 and DrawSVG-v1: trace a target outline with the stick.

Port of ``maniskill_tpu/envs/tasks/draw_targets.py``: TableTopFreeDraw's
dots plus a target outline, rotated and moved per episode and kept in the
state's extras (``outline``, (K, R, 2)), and the two-sided success test:
every touch of the canvas within ``THRESHOLD`` of some outline point
(``dots_ok``) and every outline point touched near (``ref_hit``), after at
least one touch (``drew_any``). DrawTriangle traces an equilateral
triangle of side 0.3 m (153 points); DrawSVG the JAX package's default
SVG path, read by a minimal M/L/H/V/Z path reader, scaled to 22 cm, with
500 dots.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..._consts import const
from ..base_env import EnvState, TaskContext
from ..registration import register_env
from .draw import TableTopFreeDrawEnv

_DEFAULT_SVG = (
    "M7.875 0L0 7.875V55.125L7.875 63H23.763L23.7235 62.9292L11.8418 "
    "51.2859L11.8418 35.6268L21.1302 26.915L23.9193 11.6649L40.9773 "
    "6.3631L46.8835 16.5929L33.2356 19.926L32.6417 29.1349L41.1407 "
    "33.618L50.8511 23.465L56.6781 33.5577L43.5576 45.6794L28.9369 "
    "40.4365L26.1844 42.4266L26.1844 45.6794L43.2157 63H55.125L63 "
    "55.125V7.875L55.125 0H7.875Z"
)


def _parse_svg_polyline(svg: str) -> np.ndarray:
    """The vertices (N, 2) of an SVG path of absolute M/L/H/V/Z commands."""
    pts, start, cur = [], None, np.zeros(2)
    for cmd, args in re.findall(r"([MLHVZ])([^MLHVZ]*)", svg.replace(",", " ")):
        vals = [float(v) for v in args.split()]
        if cmd == "M":
            cur = np.array(vals[:2])
            start = cur.copy()
            pts.append(cur.copy())
        elif cmd == "L":
            for i in range(0, len(vals), 2):
                cur = np.array(vals[i:i + 2])
                pts.append(cur.copy())
        elif cmd == "H":
            cur = np.array([vals[0], cur[1]])
            pts.append(cur.copy())
        elif cmd == "V":
            cur = np.array([cur[0], vals[0]])
            pts.append(cur.copy())
        elif cmd == "Z" and start is not None:
            pts.append(start.copy())
    return np.stack(pts)


def _interp_outline(verts: np.ndarray, pts_per_edge: int, closed: bool = True) -> np.ndarray:
    """Each edge of the polyline ``verts`` as ``pts_per_edge + 1`` points
    (its start and ``pts_per_edge`` inside)."""
    out = []
    n = len(verts) if closed else len(verts) - 1
    for i in range(n):
        a, b = verts[i], verts[(i + 1) % len(verts)]
        t = np.linspace(0.0, 1.0, pts_per_edge + 2)[:-1][:, None]
        out.append(a[None] * (1 - t) + b[None] * t)
    return np.concatenate(out)


class _DrawTargetEnv(TableTopFreeDrawEnv):
    THRESHOLD = 0.025
    OUTLINE: np.ndarray = None  # (R, 2), centred
    YAW_RANGE = (0.0, 2 * math.pi)

    def _default_extras(self, batch):
        R, dev = len(self.OUTLINE), self.device
        return dict(super()._default_extras(batch),
                    outline=torch.zeros(batch, R, 2, device=dev),
                    ref_hit=torch.zeros(batch, R, dtype=torch.bool, device=dev),
                    dots_ok=torch.ones(batch, dtype=torch.bool, device=dev),
                    drew_any=torch.zeros(batch, dtype=torch.bool, device=dev))

    def _initialize_episode(self, state: EnvState, gen: torch.Generator) -> EnvState:
        state = super()._initialize_episode(state, gen)
        K = state.sim.qpos.shape[0]
        pos = self._uniform(gen, (K, 2), -0.1, -0.08)
        yaw = self._uniform(gen, (K,), *self.YAW_RANGE)
        c, s = torch.cos(yaw), torch.sin(yaw)
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # (K, 2, 2)
        ref = const(self, "outline", self.OUTLINE, self.device)
        outline = ref @ rot.transpose(1, 2) + pos[:, None]
        return state.replace(extras=dict(self._default_extras(K), outline=outline))

    def _update_extras(self, state: EnvState, ctx: TaskContext) -> EnvState:
        tcp = ctx.tcp_pose.p
        touching = self._touching(tcp)
        state = super()._update_extras(state, ctx)
        ex = state.extras
        near = torch.linalg.norm(ex["outline"] - tcp[:, None, :2], dim=-1) < self.THRESHOLD
        return state.replace(extras=dict(
            ex, ref_hit=ex["ref_hit"] | (near & touching[:, None]),
            dots_ok=ex["dots_ok"] & (~touching | near.any(-1)),
            drew_any=ex["drew_any"] | touching))

    def evaluate(self, state: EnvState, ctx: TaskContext):
        ex = state.extras
        return dict(success=ex["drew_any"] & ex["dots_ok"] & ex["ref_hit"].all(-1),
                    outline_coverage=ex["ref_hit"].to(torch.float32).mean(-1))

    def _get_obs_extra(self, state, ctx, info):
        obs = super()._get_obs_extra(state, ctx, info)
        if "state" in self.obs_mode:
            K = ctx.tcp_pose.p.shape[0]
            # nine outline points, and each relative to the tip
            sub = state.extras["outline"][:, ::max(1, len(self.OUTLINE) // 9)][:, :9]
            obs["goal_points"] = sub.reshape(K, -1)
            obs["tcp_to_goal_points"] = (sub - ctx.tcp_pose.p[:, None, :2]).reshape(K, -1)
        return obs


def _triangle_outline():
    # equilateral, side 0.3 m: 3 edges of 51 points
    r = 0.15 / np.sqrt(3) * 2
    verts = np.stack([[r * np.cos(a), r * np.sin(a)]
                      for a in (np.pi / 2, np.pi / 2 + 2 * np.pi / 3, np.pi / 2 + 4 * np.pi / 3)])
    return _interp_outline(verts, 50)


def _svg_outline():
    v = _parse_svg_polyline(_DEFAULT_SVG)
    v = (v - v.mean(axis=0)) * (0.22 / 63.0)  # the 63 x 63 view box as 22 cm, centred
    v[:, 1] = -v[:, 1]  # SVG's y runs down
    return _interp_outline(v, 3, closed=False)


@register_env("DrawTriangle-v1", max_episode_steps=300)
class DrawTriangleEnv(_DrawTargetEnv):
    OUTLINE = _triangle_outline()


@register_env("DrawSVG-v1", max_episode_steps=500)
class DrawSVGEnv(_DrawTargetEnv):
    OUTLINE = _svg_outline()
    THRESHOLD = 0.05
    MAX_DOTS = 500
