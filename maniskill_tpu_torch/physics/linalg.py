"""Small fixed-size SPD solves, batched over leading dims.

Port of ``maniskill_tpu/physics/linalg.py`` (``solve_psd``,
``solve_psd_pair``): a column Cholesky held as a list of column slices, then
forward and back substitution, with the same ``max(s, 1e-12)`` pivot clamp.
"""
from __future__ import annotations

import torch

from ..math import clamps


def _cholesky_cols(A: torch.Tensor):
    """cols[j] = L[j:, j] (..., n-j)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            ck = cols[k]
            s = s - ck[..., j - k:] * ck[..., j - k:j - k + 1]
        s0 = clamps.maximum(s[..., :1], 1e-12)
        cols.append(s * torch.rsqrt(s0))
    return cols


def _substitute(cols, b: torch.Tensor) -> torch.Tensor:
    """Solve L Lᵀ x = b for b (..., n, m)."""
    n = len(cols)
    r = b
    y = []
    for j in range(n):
        yj = r[..., 0, :] / cols[j][..., 0, None]
        y.append(yj)
        r = r[..., 1:, :] - cols[j][..., 1:, None] * yj[..., None, :]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        if i < n - 1:
            tail = torch.stack(x[i + 1:], dim=-2)  # (..., n-1-i, m)
            s = s - torch.sum(cols[i][..., 1:, None] * tail, dim=-2)
        x[i] = s / cols[i][..., 0, None]
    return torch.stack(x, dim=-2)


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (..., n, n)."""
    return _substitute(_cholesky_cols(A), b[..., None])[..., 0]


def solve_psd_pair(A: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor):
    """Solve A x = b for two right-hand sides sharing one factorization (the
    split-impulse integrator's velocity and position passes)."""
    out = _substitute(_cholesky_cols(A), torch.stack([b1, b2], dim=-1))
    return out[..., 0], out[..., 1]
