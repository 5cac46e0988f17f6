"""A/B of the physics mega-kernel between two checkouts, on one GPU.

    python -m maniskill_tpu_torch.kernel_ab --parent DIR [--task PickCube-v1 ...] [--reps 20]

Builds ``csrc/megakernel.cu`` of this checkout and of the checkout at
``DIR`` (its root; only its ``maniskill_tpu_torch/csrc`` is read). For
each ``--task`` (repeat the flag for several; default PickCube-v1) it packs
one control step of K=4096 states with this checkout's row plan, from reset
states and from ``contact_state`` states, and runs both builds on the same
states, each with the static tables laid out by its own source's ``enum
Header`` and with its own plane layout: a build that exports
``mk_warps_per_block`` (one warp per env) takes the env-major (K, W_in)
plane, an older one (one thread per env) the env-last (R_in, K) plane,
whose output is transposed back before the comparison. It prints whether
the two outputs are bit-identical (and whether their values are equal:
signed zeros aside), or else the largest difference of each
output field, then the time per launch of each build in turns (parent,
change, change, parent; CUDA events, median of ``--reps`` launches each).
The parent must implement the task's pair functions and the same row
plan.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from . import _cuda, make
from .physics import megakernel

_FIELDS = ("qpos", "qvel", "free_pose", "free_vel", "lam", "lamt", "fpt", "bpos", "bquat", "axis")


def _legacy(lib) -> ctypes.CDLL:
    """Bind an env-last, one-thread-per-env build's ``mk_step``."""
    lib.mk_step.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mk_step.restype = ctypes.c_int
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--task", action="append")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    parent_csrc = args.parent / "maniskill_tpu_torch" / "csrc"
    change_path, parent_path = (_cuda.build("megakernel")[0],
                                _cuda.build("megakernel", csrc=parent_csrc)[0])
    parent = ctypes.CDLL(str(parent_path))
    warp = dict(parent=hasattr(parent, "mk_warps_per_block"), change=True)
    libs = dict(parent=megakernel.load_library(parent_path) if warp["parent"] else _legacy(parent),
                change=megakernel.load_library(change_path))
    print(f"parent {parent_path.name} ({'env-major' if warp['parent'] else 'env-last'}), "
          f"change {change_path.name}")
    sources = dict(parent=parent_csrc / "megakernel.cu", change=megakernel.SOURCE)
    stream = torch.cuda.current_stream().cuda_stream
    for task in args.task or ["PickCube-v1"]:
        env = make(task, num_envs=4096, reward_mode="dense")
        env.reset(seed=0)
        kern, plan = env.kernel, env.kernel.plan
        n_sub = 5 * env.model.params.substeps
        tabs = {n: [torch.as_tensor(a, device="cuda") for a in plan.tables(src)]
                for n, src in sources.items()}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        cst = env.contact_state(env._state, gen)
        for label, st in (("reset", env._state), ("contact", cst)):
            plane = megakernel.pack(plan, st.sim, st.cmd)
            K = plane.shape[0]
            floats, resident = kern.occupancy()
            planes = {n: plane if warp[n] else plane[:, :plan.R_in].t().contiguous()
                      for n in libs}
            outs = {n: torch.empty((K, plan.W_out) if warp[n] else (plan.R_out, K),
                                   device="cuda") for n in libs}

            def run(name):
                mf, mi = tabs[name]
                ptrs = (planes[name].data_ptr(), outs[name].data_ptr(), mf.data_ptr(),
                        mi.data_ptr(), K, n_sub)
                if warp[name]:
                    err = libs[name].mk_step(*ptrs, plan.nq, plan.F, plan.G, plan.P, plan.W_in,
                                             plan.W_out, stream)
                else:
                    err = libs[name].mk_step(*ptrs, 32, stream)
                if err:
                    raise RuntimeError(f"{name} launch failed ({err})")

            for name in libs:
                run(name)
            torch.cuda.synchronize()
            got = {n: o[:, :plan.R_out] if warp[n] else o.t() for n, o in outs.items()}
            same = torch.equal(got["parent"].view(torch.int32), got["change"].view(torch.int32))
            print(f"[ab] {task} {label}: outputs bit-identical: {same} (equal values: "
                  f"{torch.equal(got['parent'], got['change'])}; {K} x {plan.R_out} floats;"
                  f" change: slice {4 * floats} B an env, {resident} envs per SM)")
            if not same:
                diffs = []
                for f in _FIELDS:
                    sl = getattr(plan, f"o_{f}")
                    d = (got["parent"][:, sl[0]:sl[1]] - got["change"][:, sl[0]:sl[1]]).abs()
                    diffs.append(f"{f} {float(d.max()) if d.numel() else 0.0:.3e}")
                print(f"[ab] {task} {label}: max |parent - change|: {', '.join(diffs)}")
            times = {n: [] for n in libs}
            for name in ("parent", "change", "change", "parent"):
                times[name].append(_cuda.event_ms(lambda: run(name), args.reps))
            print(f"[ab] {task} {label}: ms/launch parent {times['parent']}, "
                  f"change {times['change']}")
        del env
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
