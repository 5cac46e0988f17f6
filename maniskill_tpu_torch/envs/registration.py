"""Environment registry: ``@register_env(uid, max_episode_steps=...)`` and
``make(uid, num_envs=..., device=...)``. Port of
``maniskill_tpu/envs/registration.py``."""
from __future__ import annotations

from typing import Dict, Optional

REGISTERED_ENVS: Dict[str, dict] = {}


def register_env(uid: str, max_episode_steps: Optional[int] = None, **default_kwargs):
    def deco(cls):
        if uid in REGISTERED_ENVS:
            raise ValueError(f"env id {uid} already registered")
        REGISTERED_ENVS[uid] = dict(cls=cls, max_episode_steps=max_episode_steps,
                                    kwargs=default_kwargs)
        cls.env_id = uid
        return cls

    return deco


def make(uid: str, num_envs: int = 1, device=None, **kwargs):
    """Build a registered env. ``device=None`` means ``"cuda"``; without a
    CUDA device that raises unless the caller asks for ``"cpu"``."""
    if uid not in REGISTERED_ENVS:
        raise KeyError(f"unknown env id {uid!r}; registered: {sorted(REGISTERED_ENVS)}")
    spec = REGISTERED_ENVS[uid]
    kw = dict(spec["kwargs"])
    kw.update(kwargs)
    env = spec["cls"](num_envs=num_envs, device=device, **kw)
    env.max_episode_steps = spec["max_episode_steps"]
    return env
