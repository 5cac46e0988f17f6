"""State carried across from the JAX package, and back.

The JAX package's ``EnvState``/``SimState``/``DriveCmd`` arrive as dicts of
numpy arrays keyed by field name (nested for ``EnvState``: ``sim``, ``cmd``,
``elapsed_steps``, ``extras``); the caller does the ``jax`` -> numpy step, so
this module imports no JAX. Fields the port does not model (the convex-hull
tables, the per-env PRNG key) are ignored on the way in and absent on the
way out. A JAX ``CEMState`` arrives as its mean and sigma; its PRNG key is
not carried (the port's planners draw with a ``torch.Generator``, and tests
inject the JAX draws instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .envs.base_env import EnvState
from .physics.model import DriveCmd, SimState
from .planners.cem import CEMState


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def _from_fields(cls, d: Dict, device):
    return cls(**{f.name: (None if d.get(f.name) is None else _tensor(d[f.name], device))
                  for f in dataclasses.fields(cls)})


def sim_state_from_numpy(d: Dict, device="cpu") -> SimState:
    return _from_fields(SimState, d, device)


def drive_cmd_from_numpy(d: Dict, device="cpu") -> DriveCmd:
    return _from_fields(DriveCmd, d, device)


def env_state_from_numpy(d: Dict, device="cpu") -> EnvState:
    return EnvState(
        sim=sim_state_from_numpy(d["sim"], device),
        cmd=drive_cmd_from_numpy(d["cmd"], device),
        elapsed_steps=_tensor(d["elapsed_steps"], device).to(torch.int32),
        extras={k: _tensor(v, device) for k, v in d.get("extras", {}).items()},
    )


def cem_state_from_numpy(d: Dict, device="cpu", seed: int = 0) -> CEMState:
    """A JAX ``CEMState`` (mean, sigma) with a fresh generator seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return CEMState(mean=_tensor(d["mean"], device), sigma=_tensor(d["sigma"], device),
                    generator=gen)


def to_numpy(obj):
    """A port state (or a nest of them) -> dicts of numpy arrays by field."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    raise TypeError(f"cannot convert {type(obj).__name__}")
