"""A/B of the batched SPD-solve kernel (K1) between two checkouts, on one GPU.

    python -m maniskill_tpu_torch.solve_ab --parent DIR [--n 21 ...] [--K 4096 ...]
        [--warps 8 ...] [--reps 50]

Builds ``csrc/solve_psd.cu`` of this checkout and of the checkout at ``DIR``
(its root; only its ``maniskill_tpu_torch/csrc`` is read). For each n and K
it makes SPD systems A = X Xᵀ + n I and b on the card, runs both builds on
them and prints the largest difference of their x, then times each in turns
(parent, change, change, parent; device time, ``_cuda.queued_ms``: the
mean of ``--reps`` launches back to back, the inputs warm in L2 where
they fit): this checkout's
kernel at each ``--warps`` (systems a block), the parent's kernel, and for
a parent that takes the env-last planes (one thread per system, the build
before the warp redesign) also its entry point, the two transposing copies
and the kernel, as ``solve_kernel.solve_psd`` ran it. Each time stands
beside the bound of ``solve_kernel.work``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from . import _cuda
from .physics import solve_kernel

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.solve_psd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.solve_psd.restype = ctypes.c_int
    return lib


def _runner(lib, A, b, warps, env_last, entry=False):
    """A function that launches ``lib`` once on (A, b) and returns x (K, n);
    for an env-last build with ``entry``, the planes are made in the call."""
    K, n = b.shape
    stream = torch.cuda.current_stream().cuda_stream
    if env_last:  # the one-thread build: planes (n*n, K) and (n, K), 128 threads a block
        def planes():
            return A.transpose(1, 2).reshape(K, n * n).t().contiguous(), b.t().contiguous()
        made = planes()
        xt = torch.empty((n, K), device=b.device)

        def run():
            At, bt = planes() if entry else made
            if lib.solve_psd(At.data_ptr(), bt.data_ptr(), xt.data_ptr(), n, K, 128, stream):
                raise RuntimeError("parent launch failed")
            return xt.t()
        return run
    x = torch.empty((K, n), device=b.device)

    def run():
        if lib.solve_psd(A.data_ptr(), b.data_ptr(), x.data_ptr(), n, K, warps, stream):
            raise RuntimeError("launch failed")
        return x
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--n", type=int, action="append")
    ap.add_argument("--K", type=int, action="append")
    ap.add_argument("--warps", type=int, action="append")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("solve_ab needs a CUDA device")
    ns, Ks = args.n or [21], args.K or [4096]
    warps = args.warps or [solve_kernel.WARPS]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    parent_csrc = args.parent / "maniskill_tpu_torch" / "csrc"
    env_last = "int warps" not in (parent_csrc / "solve_psd.cu").read_text()
    change_path, parent_path = (_cuda.build("solve_psd")[0],
                                _cuda.build("solve_psd", csrc=parent_csrc)[0])
    change, parent = _bind(change_path), _bind(parent_path)
    print(f"parent {parent_path.name} ({'env-last planes' if env_last else 'row-major'}), "
          f"change {change_path.name}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for n in ns:
        for K in Ks:
            X = torch.randn((K, n, n), generator=gen, device="cuda")
            A = X @ X.transpose(1, 2) + n * torch.eye(n, device="cuda")
            b = torch.randn((K, n), generator=gen, device="cuda")
            del X
            runs = {"parent": _runner(parent, A, b, solve_kernel.WARPS, env_last)}
            if env_last:
                runs["parent entry"] = _runner(parent, A, b, 0, True, entry=True)
            runs |= {f"change W={w}": _runner(change, A, b, w, False) for w in warps}
            x0 = runs["parent"]().clone()
            diffs = {k: float((r() - x0).abs().max()) for k, r in runs.items()
                     if k.startswith("change")}
            order = list(runs)
            times = {k: [] for k in order}
            for turn in (order, order[::-1]):
                for k in turn:
                    runs[k]()
                    times[k].append(_cuda.queued_ms(runs[k], args.reps))
            nbytes, ops = solve_kernel.work(K, n)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
            print(f"[ab] n={n} K={K}: bound {bound:.5f} ms; max |change - parent| "
                  + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
            for k in order:
                t = sum(times[k]) / 2
                print(f"[ab] n={n} K={K}: {k} {t:.4f} ms ({times[k][0]:.4f}, {times[k][1]:.4f}), "
                      f"{bound / t * 100:.1f} % of the bound")
            del A, b, runs
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
