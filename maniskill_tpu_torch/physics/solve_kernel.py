"""Batched small SPD solve through a CUDA kernel: wrapper and bound.

Port of the Pallas TPU kernel ``maniskill_tpu/physics/pallas_kernels.py``
(``_solve_kernel``, ``:27``, launched by ``solve_psd_pallas``, ``:62``). The
kernel is CUDA C++ in ``maniskill_tpu_torch/csrc/solve_psd.cu`` (one warp per
system, ``WARPS`` systems a block; its header note says what bounds it),
built at first use by ``maniskill_tpu_torch/_cuda.py``. It reads
``solve_psd_pallas``'s own layout, A (K, n, n) and b (K, n) row-major, and
writes x (K, n): no transposing copy on either side.

``solve_psd(A, b)`` takes A (K, n, n) and b (K, n) float32 like
``solve_psd_pallas`` (any K: warps past K exit, so no block multiple is
needed; only the lower triangle of A is read). For CUDA tensors it launches
the kernel; for CPU tensors it runs the plain version, ``linalg.solve_psd``.
``launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .linalg import solve_psd as solve_psd_plain

N_MAX = 32  # csrc/solve_psd.cu is compiled for each n from 1 to N_MAX
WARPS = 4  # systems (warps) a block: 4 and 8 within 5 %, 4 ahead at K = 65536 (PERF.md)
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


def _shape(A: torch.Tensor, b: torch.Tensor):
    """(K, n) of A (K, n, n) and b (K, n); raises on other shapes."""
    if A.dim() != 3 or b.dim() != 2 or A.shape[1] != A.shape[2] or A.shape[:2] != b.shape:
        raise ValueError(f"expected A (K, n, n) and b (K, n), got {tuple(A.shape)}, "
                         f"{tuple(b.shape)}")
    return tuple(b.shape)


def launch(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the kernel on A (K, n, n) and b (K, n), contiguous float32 CUDA
    tensors; returns x (K, n)."""
    global launches
    K, n = _shape(A, b)
    if not 1 <= n <= N_MAX or K < 1:
        raise ValueError(f"need 1 <= n <= {N_MAX} and K >= 1, got n={n}, K={K}")
    for name, t in (("A", A), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor, got {t.dtype}, "
                             f"strides {t.stride()}")
        if t.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, got {name} on {t.device}")
    lib = _load()
    x = torch.empty((K, n), dtype=torch.float32, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = lib.solve_psd(A.data_ptr(), b.data_ptr(), x.data_ptr(), n, K, WARPS, stream)
    if err != 0:
        raise RuntimeError("solve_psd launch failed: " + lib.solve_psd_error_string(err).decode())
    launches += 1
    return x


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (K, n, n), b (K, n); returns x (K, n)."""
    _shape(A, b)
    if A.device.type == "cpu":
        return solve_psd_plain(A, b)
    return launch(A.contiguous(), b.contiguous())


def work(K: int, n: int):
    """``(bytes, operations)`` of one solve: each input read once (of the
    matrix only its lower triangle, n(n+1)/2 entries, which is all the
    factor reads) and the output written once; the factor's n^3/3 and the
    two substitutions' 2 n^2 operations per system."""
    return 4 * K * (n * (n + 1) // 2 + 2 * n), K * (n ** 3 / 3 + 2 * n * n)
