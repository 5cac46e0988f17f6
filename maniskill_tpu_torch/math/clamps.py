"""Clamps and maxima with JAX's derivative convention at ties.

``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` split the derivative
0.5/0.5 between their two arguments where the arguments are equal (at a
clip bound: half to ``x``, half to the bound); ``jnp.abs`` has slope +1 at
0. ``torch.clamp``, ``clamp_min`` and ``clamp_max`` pass the whole
derivative (1) to ``x`` at the bound, and ``torch.abs`` has slope 0 at 0.
The physics step sits on such ties in ordinary states (a cube resting at
exactly zero depth, a gripper joint at its limit), so the port's
derivatives there would differ from the JAX package's.

``torch.maximum`` and ``torch.minimum`` already split a tie 0.5/0.5 in
autograd and in ``torch.func.jvp``, so the helpers call them with a scalar
bound made a cached device tensor. The primal equals the ``torch.clamp``
family's bit for bit.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from .._consts import const

_BOUNDS = SimpleNamespace()  # scalar bounds as device tensors (_consts.const)


def _tensor(b, like: torch.Tensor) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b
    return const(_BOUNDS, repr(float(b)), b, like.device, like.dtype)


def maximum(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.maximum``: elementwise max, derivative 0.5/0.5 at a tie."""
    return torch.maximum(a, _tensor(b, a))


def minimum(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.minimum``: elementwise min, derivative 0.5/0.5 at a tie."""
    return torch.minimum(a, _tensor(b, a))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)


clamp_min = maximum
clamp_max = minimum


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 (mirrors jnp.abs)
    """``jnp.abs``: |x| with slope +1 at 0."""
    return torch.where(x < 0, -x, x)
