"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``maniskill_tpu_torch/_build/``
keyed by a hash of the source and the shared headers (``csrc/*.cuh``), and
loaded with ``ctypes``. ``build`` starts one ``nvcc`` per source, all at
once. The compiler's report (``-Xptxas -v``: registers, stack, spills) is
kept beside each library as ``.log``. ``event_ms`` times device work with
CUDA events, ``queued_ms`` device work shorter than its host call. Nothing
here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else "nvcc"


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``<csrc>/<name>.cu`` is built, by the hash of its sources."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for hdr in sorted(csrc.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(*names: str, csrc: Path = CSRC) -> list:
    """Compile ``<csrc>/<name>.cu`` for each name not built yet, one
    ``nvcc`` process each, all running together; returns the libraries'
    paths. ``csrc`` defaults to this package's sources (another checkout's
    serves A/B comparisons). Raises if any compile fails."""
    csrc = Path(csrc)
    jobs = []
    for name in names:
        lib = library_path(name, csrc)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", str(csrc), "-o", tmp, str(csrc / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, lib, tmp, proc))
    errors = []
    for name, lib, tmp, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n, csrc) for n in names]


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[0]))


def event_ms(fn, reps: int) -> float:
    """Median device time in ms of ``fn()`` over ``reps`` runs, each timed
    by a pair of CUDA events on the current stream."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, reps: int, sleep_cycles: int = 20_000_000) -> float:
    """Mean device time in ms of ``fn()`` over ``reps`` runs back to back.
    The runs are queued behind a device spin of ``sleep_cycles`` cycles, so
    the card runs them without waiting on the host: a launch shorter than
    its host call would otherwise time the host. If the spin ended before
    the last run was queued, the spin is doubled and the runs timed again."""
    import torch

    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_in_time = not a.query()  # the card still spinning: nothing waited on the host
        b.synchronize()
        if queued_in_time:
            return a.elapsed_time(b) / reps
        sleep_cycles *= 2
    raise RuntimeError(f"the host took longer to queue {reps} runs than the card's spin")
