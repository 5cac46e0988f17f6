"""Batched small SPD solve through a CUDA kernel: wrapper, layout, bound.

Port of the Pallas TPU kernel ``maniskill_tpu/physics/pallas_kernels.py``
(``_solve_kernel``, ``:27``, launched by ``solve_psd_pallas``, ``:62``). The
kernel is CUDA C++ in ``maniskill_tpu_torch/csrc/solve_psd.cu`` (one system
per thread; its header note says what bounds it), built at first use by
``maniskill_tpu_torch/_cuda.py``. It keeps the TPU kernel's env-last
layout: the matrix plane is (n*n, K) with row ``j*n + i`` holding
``A[:, i, j]``, and b and x are (n, K).

``solve_psd(A, b)`` takes A (K, n, n) and b (K, n) float32 like
``solve_psd_pallas`` (any K: threads past K exit, so no block multiple is
needed). For CUDA tensors it launches the kernel; for CPU tensors it runs
the plain version, ``linalg.solve_psd``. ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .linalg import solve_psd as solve_psd_plain

N_MAX = 32  # the kernel's compile-time cap (csrc/solve_psd.cu)
BLOCK = 128
launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _cuda.load("solve_psd")
        lib.solve_psd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.solve_psd.restype = ctypes.c_int
        lib.solve_psd_error_string.argtypes = [ctypes.c_int]
        lib.solve_psd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def to_planes(A: torch.Tensor, b: torch.Tensor):
    """(K, n, n), (K, n) -> the env-last planes (n*n, K), (n, K)."""
    K, n, _ = A.shape
    return A.transpose(1, 2).reshape(K, n * n).t().contiguous(), b.t().contiguous()


def launch(At: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Run the kernel on env-last planes; returns x as an (n, K) plane."""
    global launches
    n, K = bt.shape
    for name, t, shape in (("At", At, (n * n, K)), ("bt", bt, (n, K))):
        if t.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 {shape} plane, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= n <= N_MAX or K < 1:
        raise ValueError(f"need 1 <= n <= {N_MAX} and K >= 1, got n={n}, K={K}")
    lib = _load()
    xt = torch.empty((n, K), dtype=torch.float32, device=bt.device)
    stream = torch.cuda.current_stream(bt.device).cuda_stream
    err = lib.solve_psd(At.data_ptr(), bt.data_ptr(), xt.data_ptr(), n, K, BLOCK, stream)
    if err != 0:
        raise RuntimeError("solve_psd launch failed: " + lib.solve_psd_error_string(err).decode())
    launches += 1
    return xt


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (K, n, n), b (K, n); returns x (K, n)."""
    if A.dim() != 3 or b.dim() != 2 or A.shape[1] != A.shape[2] or A.shape[:2] != b.shape:
        raise ValueError(f"expected A (K, n, n) and b (K, n), got {tuple(A.shape)}, "
                         f"{tuple(b.shape)}")
    if A.device.type == "cpu":
        return solve_psd_plain(A, b)
    return launch(*to_planes(A, b)).t()


def work(K: int, n: int):
    """``(bytes, operations)`` of one solve: each input read once (of the
    matrix only its lower triangle, n(n+1)/2 entries, which is all the
    factor reads) and the output written once; the factor's n^3/3 and the
    two substitutions' 2 n^2 operations per system."""
    return 4 * K * (n * (n + 1) // 2 + 2 * n), K * (n ** 3 / 3 + 2 * n * n)
