"""Static model arrays (numpy) as device tensors, copied once per device.

A host-to-device copy of a small constant on every call would stall the
stream on each control step; the tensor is cached on the object that owns
the numpy array instead."""
from __future__ import annotations

import numpy as np
import torch


def const(owner, key: str, array, device, dtype=None) -> torch.Tensor:
    """``array`` as a tensor on ``device``, cached on ``owner`` under ``key``.
    ``dtype=None`` is torch's default dtype: float32, unless the caller set
    float64 for a reference run of the plain physics step."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    cache = owner.__dict__.setdefault("_torch_consts", {})
    k = (key, str(torch.device(device)), dtype)
    t = cache.get(k)
    if t is None:
        # made outside any torch.func transform: a tensor created inside one
        # is wrapped for that transform's level and must not outlive it
        with torch._C._DisableFuncTorch():
            t = torch.as_tensor(np.asarray(array), dtype=dtype, device=device)
        cache[k] = t
    return t
