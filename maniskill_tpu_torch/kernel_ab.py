"""A/B of the physics mega-kernel between two checkouts, on one GPU.

    python -m maniskill_tpu_torch.kernel_ab --parent DIR [--task PickCube-v1] [--reps 20]

Builds ``csrc/megakernel.cu`` of this checkout and of the checkout at
``DIR`` (its root; only its ``maniskill_tpu_torch/csrc`` is read), packs
one control step of K=4096 states of ``--task`` with this checkout's row
plan, from reset states and from ``contact_state`` states, and runs both
builds on the same input plane. It prints whether the two output planes
are bit-identical (and the largest difference if not), then the time per
launch of each, in turns (parent, change, change, parent; CUDA events,
median of ``--reps`` launches each). The parent must implement the task's
pair functions and the same plane layout.
"""
from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from . import _cuda, make
from .physics import megakernel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--task", default="PickCube-v1")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    change_path = _cuda.build("megakernel")[0]
    parent_path = _cuda.build("megakernel", csrc=args.parent / "maniskill_tpu_torch" / "csrc")[0]
    libs = dict(parent=megakernel.load_library(parent_path),
                change=megakernel.load_library(change_path))
    print(f"parent {parent_path.name}, change {change_path.name}")

    env = make(args.task, num_envs=4096, reward_mode="dense")
    env.reset(seed=0)
    plan = env.kernel.plan
    mf, mi = (torch.as_tensor(a, device="cuda") for a in plan.tables())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cst = env.contact_state(env._state, gen)
    stream = torch.cuda.current_stream().cuda_stream
    for label, st in (("reset", env._state), ("contact", cst)):
        plane = megakernel.pack(plan, st.sim, st.cmd)
        K = plane.shape[1]
        outs = {n: torch.empty((plan.R_out, K), device="cuda") for n in libs}

        def run(name):
            err = libs[name].mk_step(plane.data_ptr(), outs[name].data_ptr(), mf.data_ptr(),
                                     mi.data_ptr(), K, 5, megakernel.BLOCK, stream)
            if err:
                raise RuntimeError(f"{name} launch failed ({err})")

        for name in libs:
            run(name)
        torch.cuda.synchronize()
        same = torch.equal(outs["parent"], outs["change"])
        diff = float((outs["parent"] - outs["change"]).abs().max())
        print(f"[ab] {args.task} {label}: outputs bit-identical: {same} (max |parent - change| "
              f"{diff:.3e}, {plan.R_out} x {K} floats)")
        times = {n: [] for n in libs}
        for name in ("parent", "change", "change", "parent"):
            times[name].append(_cuda.event_ms(lambda: run(name), args.reps))
        print(f"[ab] {args.task} {label}: ms/launch parent {times['parent']}, "
              f"change {times['change']}")


if __name__ == "__main__":
    main()
