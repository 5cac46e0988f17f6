"""Run a scripted solution on a batch of envs and print its success rate.

    python -m maniskill_tpu_torch.examples.motionplanning.run -e PickCube-v1 -n 16
    python -m maniskill_tpu_torch.examples.motionplanning.run -e PickCube-v1 -n 4 --device cpu

Port of ``maniskill_tpu/examples/motionplanning/run.py`` without trajectory
recording: ``--traj-dir`` raises until the port has its ``trajectory``
module.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import maniskill_tpu_torch as mtt

from .solutions import CONTROL_MODES, SOLUTIONS


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PickCube-v1", choices=sorted(SOLUTIONS))
    p.add_argument("-n", "--num-envs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device; default: cuda")
    p.add_argument("--traj-dir", default=None,
                   help="trajectory recording: waits for the port's trajectory module")
    args = p.parse_args(argv)
    if args.traj_dir:
        raise NotImplementedError(
            "--traj-dir waits for the port's trajectory module (trajectory/); "
            "run without it to solve and print the success rate")
    env = mtt.make(args.env_id, num_envs=args.num_envs, device=args.device,
                   control_mode=CONTROL_MODES.get(args.env_id, "pd_ee_delta_pos"),
                   robot_init_qpos_noise=0.0)
    env.reset(seed=args.seed)
    t0 = time.perf_counter()
    success = SOLUTIONS[args.env_id](env)
    dt = time.perf_counter() - t0
    steps = int(env._state.elapsed_steps[0])
    print(f"{args.env_id}: solved {int(np.sum(success))}/{args.num_envs} in {steps} control "
          f"steps, {dt:.1f} s ({steps * args.num_envs / dt:.1f} env steps/s)")
    return success


if __name__ == "__main__":
    main()
