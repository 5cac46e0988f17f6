"""Reward shaping utilities; port of ``maniskill_tpu/envs/rewards.py``.

``tolerance`` returns 1 inside [lower, upper] and decays sigmoidally outside
with the chosen profile (dm_control style).
"""
from __future__ import annotations

import numpy as np
import torch


def tolerance(x: torch.Tensor, lower: float = 0.0, upper: float = 0.0,
              margin: float = 0.0, sigmoid: str = "gaussian",
              value_at_margin: float = 0.1) -> torch.Tensor:
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return in_bounds.to(torch.float32)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    if sigmoid == "gaussian":
        scale = np.sqrt(-2 * np.log(value_at_margin))
        value = torch.exp(-0.5 * (d * scale) ** 2)
    elif sigmoid == "hyperbolic":
        scale = np.arccosh(1 / value_at_margin)
        value = 1.0 / (1.0 + torch.exp(d * scale))
    elif sigmoid == "quadratic":
        sd = d * np.sqrt(1 - value_at_margin)
        value = torch.where(torch.abs(sd) < 1, 1 - sd ** 2, torch.zeros_like(sd))
    elif sigmoid == "linear":
        sd = d * (1 - value_at_margin)
        value = torch.where(torch.abs(sd) < 1, 1 - sd, torch.zeros_like(sd))
    elif sigmoid == "long_tail":
        scale = np.sqrt(1 / value_at_margin - 1)
        value = 1.0 / ((d * scale) ** 2 + 1)
    elif sigmoid == "cosine":
        sd = d * (np.arccos(2 * value_at_margin - 1) / np.pi)
        value = torch.where(torch.abs(sd) < 1, (1 + torch.cos(np.pi * sd)) / 2,
                            torch.zeros_like(sd))
    else:
        raise ValueError(f"Unknown sigmoid type {sigmoid!r}")
    return torch.where(in_bounds, torch.ones_like(value), value).to(torch.float32)
