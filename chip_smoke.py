#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or ends the script with a non-zero exit):
  1. build both CUDA libraries from the sources in this checkout, one
     ``nvcc`` per source, all at once: the physics mega-kernel (K2,
     ``csrc/megakernel.cu``: one warp per env, its state in a slice of
     shared memory) and the batched SPD solve (K1, ``csrc/solve_psd.cu``),
     with the compiler's report (registers, stack, spills, shared memory);
  2. hold K2 against its plain PyTorch step on the card, for PickCube-v1
     and StackCube-v1 (two free cubes: the free-free box_box pair) at
     K=4096, for PickSingleYCB-v1 at K=8192 (the plane its MPPI path
     launches) and for PickSingleHull-v1 at K=4096 (a convex hull per env,
     all 8 library objects present: plane_hull and box_hull), and for
     PlugCharger-v1 (capsule prongs: capsule_box, plane_capsule,
     capsule_capsule; 20 substeps a control step) and RollBall-v1 (a ball:
     sphere_box, plane_sphere) at K=4096: one control step of states with
     perturbed drive targets (the new tasks' contact states under their own
     command), aux outputs included, from
     reset states and from states in contact (``contact_state``; the check
     fails unless every pair function and friction carry force there), then
     a 10-control-step settle check through the kernel alone; time the
     kernel and its plain version and count the step's work for the bound,
     with the scene's slice bytes and resident envs per SM, and check that
     two launches on one plane give the same bits;
     the same for RotateSingleObjectInHandLevel2-v1 at K=4096 (the Allegro
     hand, nq 16, a hull per env on 16 capsules: capsule_hull,
     plane_capsule), reset envs whose dropped object touches the hand in
     the step and the settled contact states refereed by a float64 plain
     step, with the share of envs whose capsule_hull points carry force;
     then the hull stack (``physics/hull_stack.py``: sphere_hull and both
     halves of hull_hull loaded), dropped and settled; the articulated
     scenes (robot-only, F=0, a kinematic forest of the robot's tree and
     an object's) FoldSuitcaseModels-v1 (all four containers present),
     TurnFaucet-v1 and OpenCabinetDrawer-v1 (the Fetch) at K=4096, reset
     states (envs where a point carries force within the step refereed,
     the rest held in full) and contact states (fingers pressing the lid,
     the handle or the drawer: box_box_corners points with a robot link
     on each side, whose share of loaded envs is printed and gated; a lid
     or a drawer past its open limit), then a 10-control-step settle of the contact
     states through the kernel, with the share of envs whose object sits
     in its open-limit band (gated for the suitcase's lid); the control
     suite at K=4096 (``control_phase``: torque actuation, one control step
     of 4 sim steps of 2 substeps): MS-HumanoidStand-v1 (nq 27, P 35) and
     MS-HopperStand-v1 from reset states under random torques and from
     states on the floor (standing and lying: plane_capsule and
     plane_sphere loaded, with friction; each env refereed one by one by a
     float64 plain step, and the referee shown to catch a kernel with a 1 %
     fault planted in its friction or normal-gain table), then a
     10-control-step settle;
     MS-CartpoleBalance-v1 (P = 0, G = 0) from reset states and after a
     10-step settle, every env held in full; the rest of the BASELINE MPC
     set at K=4096: PushCube-v1 (its cube held as PickCube's), PokeCube-v1
     (a held peg pressing a cube: the free-free box_box points loaded) and
     PegInsertionSide-v1 (a peg sized per env through geom_size, held with
     its head in a hole of four kinematic walls: peg-wall points loaded);
     and K2 on
     PickCube reset states at K=1 (iLQR's rollouts) and at a ragged
     K=4,097, every env within the tolerances;
  3. the differentiable step on the card: the JVP and the VJP of one
     StackCube ``_rollout_step`` through ``KernelStep`` (kernel primal,
     plain-step derivative) against those of the plain step, K=64;
  4. drive the port's PickCube main path: ``make("PickCube-v1")``,
     ``reset``, then MPPI at H=50, K=4096 (sigma 0.6, temperature 0.3): one
     warm-up solve and 3 timed solves, with K2's launch count read around
     them;
  5. drive the PickSingleYCB-v1 path at BASELINE config #5: MPPI at H=50,
     K=8192 (sigma 0.4 per arm joint and 0.1 for the gripper, temperature
     0.1): one warm-up solve and 3 timed solves, 50 kernel launches each;
     then the PlugCharger-v1, RollBall-v1 and
     RotateSingleObjectInHandLevel2-v1 paths at the bench shape (H=50,
     K=4096, sigma 0.6, temperature 0.3) the same way; then the
     articulated paths: FoldSuitcase-v1 at the bench shape, TurnFaucet-v1
     (H=20, K=2048, sigma 0.5, temperature 0.2) and OpenCabinetDrawer-v1
     (H=40, K=2048, a sigma per action dimension, temperature 0.2, the
     cabinet's approach prior as the first nominal), the JAX package's
     planner configs (each env class's ``MPPI_CONFIG``), one kernel launch a
     rollout step; then the control-suite paths, MS-HumanoidStand-v1,
     MS-CartpoleBalance-v1 and MS-HopperStand-v1, at the bench shape;
     then the rest of the BASELINE MPC set: PegInsertionSide-v1 MPPI at
     BASELINE config #4 (H=80, K=16384, sigma 0.4 per arm joint and 0.1 for
     the gripper, temperature 0.1: 80 kernel launches a solve) and
     PokeCube-v1 MPPI at its planner config (H=25, K=2048); then PushCube-v1
     episodes at its planner config (H=20, K=2048), seed 0, 50 control
     steps: ``run_episode_device`` (each control step one CUDA graph:
     the MPPI solve with its noise draw, the env step, the freeze after
     success; replayed 50 times under ``set_sync_debug_mode("error")``)
     against ``run_episode`` (the host loop): the first actions agree within
     1e-4, the cube ends nearer its goal, the graph holds 21 K2 kernel
     nodes (read from the graph: the replays launch K2 without its
     wrapper, which counts the warm-up step and the capture only); a
     second device episode's 10 replays under torch.profiler for their
     device busy and K2 times; the
     graph's node count and capture time; and one device episode at
     BASELINE config #1's literal shape (H=30, K=256);
  6. drive the StackCube path: ``make("StackCube-v1")``, ``reset``, then
     CEM + iLQR at BASELINE config #3 (CEM H=60, K=1024, 64 elites, 4
     iterations, sigma 0.5; iLQR H=60, 3 iterations): one warm-up and 1
     timed plan step, split into CEM and iLQR (and iLQR into its rollouts,
     linearizations and line searches), K2's launches per plan step
     checked against the design, then one env step with the planned action;
  7. hold K1 against its plain version (n = 1, 9, 15, 21, 27, 32; K =
     4096, 37 and 1; SPD systems and non-PD ones with exact pivots, the
     strict upper triangle of A NaN), time it (launches back to back, device
     time) beside its entry point and the library call at n = 9, 15, 21,
     27 and K = 4096, 16384, 65536, and its plain version at K = 4096, and
     drive its entry point once;
  8. the Panda's control modes on PickCube-v1 at K=4096 (``[modes]``):
     one control step of each of the eight modes' controllers from reset
     and contact states through K2 against the plain step, and one
     ``env.step`` each through the entry point (K2 launched once, K1 once
     under a task-space mode); the task-space IK path (``[ee]``): K1 on
     the controller's own IK systems (n = 6 under pd_ee_delta_pose, n = 3
     under pd_ee_delta_pos) against its plain version, the targets through
     K1 against those through the plain version, K1's time beside the
     plain version's and the library call's, one rollout step under
     ``set_sync_debug_mode("error")``, and PickCube MPPI at the bench shape
     under each EE mode (50 K1 and 50 K2 launches a solve); the scripted
     solutions (``[solutions]``): PullCubeTool-v1's K2 check and slice,
     every ported solution at B=1024 on K2 (success rate, env steps/s, one
     K2 and one K1 launch a control step, final states finite), and
     PickCube-v1 and FoldSuitcase-v1 at B=256 on K2 and on the plain step,
     whose success rates must agree;
  9. print one JSON line of the kernels (launches on their paths, time per
     launch, bound, plain version's and library call's time), the card's
     name and power limit, and last the contract line
     ``{"ok": true, "device": {...}}``. ``[lap]`` lines give each phase's
     seconds.
Needs one CUDA device; exits non-zero without one or outside the repo.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

K_CHECK = 4096
# timed MPPI solves a path, after one warm-up (5 until PR 11; cut to keep
# the whole run within its time limit as phases are added)
TIMED_SOLVES = 3
# PickSingleYCB-v1 MPPI, BASELINE config #5 (the JAX package's
# tools/solve_tasks.py:90-94)
K_YCB, SIGMA_YCB, TEMP_YCB = 8192, [0.4] * 7 + [0.1], 0.1
# StackCube CEM + iLQR (BASELINE config #3, the JAX package's
# tools/solve_tasks.py:80-84)
H_PLAN, K_CEM, ELITES, CEM_ITERS, ILQR_ITERS = 60, 1024, 64, 4, 3
TIMED_PLANS = 1  # timed CEM + iLQR plan steps after one warm-up (2 until PR 11)
K_SEAM = 64
# PushCube-v1 episodes: control steps, and how far the device loop's first
# action may be from the host loop's (one program, the same draws)
EPISODE_STEPS, EPISODE_TOL = 50, 1e-4
# replays of the profiled device episode (a replay is ~11,300 device ops)
PROFILED_STEPS = 10
# the MPPI paths' bound counts every 10th launch of the warm-up solve
# (rollout steps 0, 10, ..., 40; every 5th until PR 11): megakernel.work
# reruns the plain step substep by substep, about two plain steps a launch
# (PlugCharger 1.2 s)
PATH_BOUND_EVERY = 10
# kernel vs plain tolerances (tests/test_torch_pickcube.py, from
# tests/test_megakernel.py:48-67): float32 on both sides, sums in another
# order; contact impulses are newtons under a stiff implicit law
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
AUX_TOL = dict(body_pos=2e-5, body_quat=2e-5, axis_w=2e-5, f_pt=5e-3)
CONTACT_SHARE = 0.05  # share of contact-state envs that may leave the tolerances
# a refereed env held one by one (``disagreement``'s ``per_env``): the
# kernel may be this many times further from a float64 plain step than the
# float32 plain step is
REFEREE_FACTOR = 3.0
# the seam: per env, |kernel-primal derivative - plain derivative| over the
# env's largest plain derivative; the derivatives themselves come from the
# same plain step, but the reward's are taken at the kernel's primal, which
# differs from the plain step's by float32 rounding
SEAM_REL_TOL = 1e-3
K1_TOL = 1e-4  # A = X Xᵀ + n I, float32, n <= 32; the IK systems of the EE modes
# the scripted solutions: envs a solution runs on K2, and the envs of the
# K2 / plain-step comparison of success rates
K_SOL, K_SOL_AB = 1024, 256
# K1 on non-PD systems (exact pivots): finite entries against the system's
# largest |x|, and a diagonal system's entry by entry
K1_REL_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def as64(x):
    """A state or command dataclass with its float tensors in float64."""
    import torch

    return x.replace(**{f.name: v.double() for f in dataclasses.fields(x)
                        if isinstance(v := getattr(x, f.name), torch.Tensor)
                        and v.is_floating_point()})


def new_profile():
    """A torch.profiler profile of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)


def device_rows(prof):
    """(name, device microseconds, count) of a finished profile's
    device-side rows (kernels, copies): operator rows repeat the device
    time of the kernels they launch, so they are left out."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0]


def profile_solve(planner, ps, state):
    """Where one solve's device time goes (torch.profiler over one solve):
    device busy share of the wall time and the top kernels by device time.
    Runs after the launch count is read; prints "not measured" when the
    profiler sees no device activity."""
    import torch

    with new_profile() as prof:
        t0 = time.perf_counter()
        planner.solve(ps, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        print("[profile] device time: not measured (no CUDA activity recorded)")
        return
    n_kernels = sum(r[2] for r in rows)
    print(f"[profile] one solve: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{n_kernels} device ops")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def pickcube_branches(env, plan, cst, loaded, depth):
    """What must carry force in PickCube contact states, per env that should."""
    import torch

    pfn = torch.as_tensor(plan.pfn, device="cuda")
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device="cuda")
    grasp = torch.arange(loaded.shape[0], device="cuda") % 4 != 3
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    margin = env.model.params.contact_margin
    return {
        "finger-cube box_box_corners loaded": loaded[grasp][:, pfn == 2].sum(1) >= 4,
        "cube-table box_box_onesided loaded": loaded[grasp][:, (pfn == 1) & ~robot].sum(1) >= 1,
        "fingertip-table box_box_onesided active":
            (depth[grasp][:, (pfn == 1) & robot] > -margin).sum(1) >= 4,
        "cube-floor plane_box loaded": loaded[~grasp][:, pfn == 0].sum(1) >= 1,
        "friction lam_t nonzero": lam_t[grasp].sum(1) >= 6,
    }


def stackcube_branches(env, plan, cst, loaded, depth):
    """What must carry force in StackCube contact states (even envs: cubeA
    on cubeB; odd envs: cubeA grasped, cubeB on the floor in every fourth)."""
    import torch

    pfn = torch.as_tensor(plan.pfn, device="cuda")
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device="cuda")
    idx = torch.arange(loaded.shape[0], device="cuda")
    stacked, floor = idx % 2 == 0, idx % 4 == 3
    grasp = ~stacked
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    margin = env.model.params.contact_margin
    return {
        "cubeA-cubeB box_box loaded": loaded[stacked][:, pfn == 3].sum(1) >= 1,
        "cubeA-cubeB box_box friction lam_t nonzero": lam_t[stacked][:, pfn == 3].sum(1) >= 1,
        "finger-cube box_box_corners loaded": loaded[grasp][:, pfn == 2].sum(1) >= 4,
        "cube-table box_box_onesided loaded": loaded[grasp][:, (pfn == 1) & ~robot].sum(1) >= 1,
        "fingertip-table box_box_onesided active":
            (depth[grasp][:, (pfn == 1) & robot] > -margin).sum(1) >= 4,
        "cubeB-floor plane_box loaded": loaded[floor][:, pfn == 0].sum(1) >= 1,
        "friction lam_t nonzero (grasps)": lam_t[grasp].sum(1) >= 6,
    }


def hull_branches(env, plan, cst, loaded, depth):
    """What must carry force in PickSingleHull contact states (the object
    grasped and on the table, or on the floor in every fourth env)."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    pfn = torch.as_tensor(plan.pfn, device="cuda")
    box_hull, plane_hull = pfn == _FNS.index("box_hull"), pfn == _FNS.index("plane_hull")
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device="cuda")
    corner = torch.as_tensor(plan.pcorner < 8, device="cuda")
    grasp = torch.arange(loaded.shape[0], device="cuda") % 4 != 3
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: loaded box_hull points {int(loaded[:, box_hull].sum())}"
          f" (box corners against the hull {int(loaded[:, box_hull & corner].sum())}, hull points"
          f" against a box {int(loaded[:, box_hull & ~corner].sum())}), plane_hull "
          f"{int(loaded[:, plane_hull].sum())}")
    return {
        "finger-object box_hull loaded": loaded[grasp][:, box_hull & robot].sum(1) >= 2,
        "object-table box_hull loaded": loaded[grasp][:, box_hull & ~robot].sum(1) >= 1,
        "object-floor plane_hull loaded": loaded[~grasp][:, plane_hull].sum(1) >= 1,
        "friction lam_t nonzero (grasps)": lam_t[grasp].sum(1) >= 4,
    }


def plug_branches(env, plan, cst, loaded, depth):
    """What must carry force in PlugCharger contact states (by env index
    modulo 4: 0 held with the prongs on their slots' floors, 1 held
    lengthwise with a finger on the prong tips, 2 held across the base on
    the table, 3 on the floor: nose down on the prong tips where the index
    modulo 8 is 3, flat where it is 7)."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    pfn = torch.as_tensor(plan.pfn, device=dev)
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device=dev)
    wall = torch.as_tensor([env.model.geoms[b].name == "receptacle" for b in plan.pgb], device=dev)
    capsule_box = pfn == _FNS.index("capsule_box")
    idx = torch.arange(loaded.shape[0], device=dev)
    grasp = idx % 4 != 3
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: loaded capsule_box points against "
          f"the receptacle {int(loaded[:, capsule_box & wall].sum())}, against a finger "
          f"{int(loaded[:, capsule_box & robot].sum())}; plane_capsule "
          f"{int(loaded[:, pfn == _FNS.index('plane_capsule')].sum())}")
    return {
        "prong-receptacle capsule_box loaded": loaded[idx % 4 == 0][:, capsule_box & wall].sum(1) >= 2,
        "prong-finger capsule_box loaded": loaded[idx % 4 == 1][:, capsule_box & robot].sum(1) >= 1,
        "finger-base box_box_corners loaded": loaded[grasp][:, pfn == _FNS.index("box_box_corners")].sum(1) >= 2,
        "prong-floor plane_capsule loaded": loaded[idx % 8 == 3][:, pfn == _FNS.index("plane_capsule")].sum(1) >= 2,
        "base-floor plane_box loaded": loaded[idx % 8 == 7][:, pfn == _FNS.index("plane_box")].sum(1) >= 2,
        "friction lam_t nonzero (grasps)": lam_t[grasp].sum(1) >= 4,
    }


def roll_branches(env, plan, cst, loaded, depth):
    """What must carry force in RollBall contact states (by env index: the
    ball on a finger of the upturned hand where it is 0 modulo 8, on the
    floor where it is 3 modulo 4, else on the table)."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    pfn = torch.as_tensor(plan.pfn, device=dev)
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device=dev)
    sphere_box = pfn == _FNS.index("sphere_box")
    idx = torch.arange(loaded.shape[0], device=dev)
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    finger, floor = idx % 8 == 0, idx % 4 == 3
    table = ~finger & ~floor
    return {
        "ball-finger sphere_box loaded": loaded[finger][:, sphere_box & robot].sum(1) >= 1,
        "ball-table sphere_box loaded": loaded[table][:, sphere_box & ~robot].sum(1) >= 1,
        "ball-floor plane_sphere loaded": loaded[floor][:, pfn == _FNS.index("plane_sphere")].sum(1) >= 1,
        "friction lam_t nonzero (table, floor)": lam_t[~finger].sum(1) >= 1,
    }


def poke_branches(env, plan, cst, loaded, depth):
    """What must carry force in PokeCube contact states (the peg held
    between the fingers, the cube pressed against its head): the finger-peg
    box_box_corners points and the peg-cube box_box points (the scene's two
    free bodies against each other), with friction. Prints the share of
    envs with peg-cube points loaded."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    pfn = torch.as_tensor(plan.pfn, device=dev)
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device=dev)
    box_box = pfn == _FNS.index("box_box")
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: peg-cube box_box points loaded "
          f"in {100 * float(loaded[:, box_box].any(1).float().mean()):.1f} % of the envs "
          f"({int(loaded[:, box_box].sum())} points)")
    return {
        "finger-peg box_box_corners loaded":
            loaded[:, pfn == _FNS.index("box_box_corners")].sum(1) >= 4,
        "peg-cube box_box loaded": loaded[:, box_box].sum(1) >= 1,
        "peg/cube-table box_box_onesided loaded":
            loaded[:, (pfn == _FNS.index("box_box_onesided")) & ~robot].sum(1) >= 1,
        "friction lam_t nonzero": lam_t.sum(1) >= 6,
    }


def peg_branches(env, plan, cst, loaded, depth):
    """What must carry force in PegInsertionSide contact states (the held
    peg's head in the hole, on its bottom wall; in odd envs also against
    the side wall at +y): the finger-peg box_box_corners points and the
    peg-wall box_box_onesided points (a free box against the kinematic
    box's four wall geoms: the pair table's function for a free body
    against a kinematic one), with friction. Prints the share of envs
    with peg-wall points loaded."""
    import numpy as np
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    pfn = torch.as_tensor(plan.pfn, device=dev)
    geoms = env.model.geom_indices("box_with_hole")
    wall = torch.as_tensor(np.isin(plan.pga, geoms) | np.isin(plan.pgb, geoms), device=dev)
    side = torch.as_tensor(np.isin(plan.pga, geoms[:1]) | np.isin(plan.pgb, geoms[:1]),
                           device=dev)
    odd = torch.arange(loaded.shape[0], device=dev) % 2 == 1
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: peg-wall box_box_onesided points "
          f"loaded in {100 * float(loaded[:, wall].any(1).float().mean()):.1f} % of the envs "
          f"({int(loaded[:, wall].sum())} points), against the +y wall in "
          f"{100 * float(loaded[odd][:, side].any(1).float().mean()):.1f} % of the odd envs")
    return {
        "finger-peg box_box_corners loaded":
            loaded[:, pfn == _FNS.index("box_box_corners")].sum(1) >= 4,
        "peg-wall box_box_onesided loaded": loaded[:, wall].sum(1) >= 1,
        "peg-side-wall box_box_onesided loaded (odd envs)": loaded[odd][:, side].sum(1) >= 1,
        "peg-wall friction lam_t nonzero": lam_t[:, wall].sum(1) >= 1,
    }


def inhand_branches(env, plan, cst, loaded, depth):
    """What must carry force in the in-hand contact states (the dropped
    object settled on the fingers): the object's capsule_hull points, with
    friction. Prints the share of envs with capsule_hull points loaded."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    capsule_hull = torch.as_tensor(plan.pfn == _FNS.index("capsule_hull"), device=dev)
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    held = loaded[:, capsule_hull].any(1)
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: capsule_hull points loaded in "
          f"{100 * float(held.float().mean()):.1f} % of the envs "
          f"({int(loaded[:, capsule_hull].sum())} points), plane_capsule "
          f"{int(loaded[:, ~capsule_hull].sum())}")
    return {
        "object-finger capsule_hull loaded": held,
        "friction lam_t nonzero (capsule_hull)": lam_t[:, capsule_hull].any(1),
    }


def stack_phase(megakernel):
    """K2 against its plain step on the hull stack (physics/hull_stack.py),
    the one scene that holds sphere_hull and hull_hull: dropped (each body
    1 mm over the one below) and settled (10 sim steps of the plain step),
    both refereed as the in-hand contact states: three bodies landing on
    one another amplify float32 rounding (the plain float32 step against a
    float64 one, dropped: free vel 8.5e-5 in the median env, 4.4e-4 at
    most; CPU, K=512), and the kernel sits as far from the plain step. Both
    must leave sphere_hull and both halves of hull_hull (the block's cloud
    against the slab's planes, the slab's against the block's) loaded in
    90 % of the envs. Times the kernel and the plain step on the settled
    states and counts their bound."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms
    from maniskill_tpu_torch.physics.hull_stack import hull_stack

    task = f"hull stack K={K_CHECK}"
    model, sim, cmd = hull_stack(K_CHECK, "cuda")
    kern = megakernel.MegaKernel(model)
    plan = kern.plan
    pfn = torch.as_tensor(plan.pfn, device="cuda")
    corner = torch.as_tensor(plan.pcorner, device="cuda")
    hh = pfn == megakernel._FNS.index("hull_hull")
    masks = {"sphere_hull": pfn == megakernel._FNS.index("sphere_hull"),
             "hull_hull block on slab": hh & (corner < 40),
             "hull_hull slab under block": hh & (corner >= 40),
             "plane_hull": pfn == megakernel._FNS.index("plane_hull")}
    settled = kern.plain(sim, cmd, 10)[0]
    errs = []
    for label, s_in in (("dropped", sim), ("settled", settled)):
        referee = torch.ones(K_CHECK, dtype=torch.bool, device="cuda")
        err, _, ref = compare_step(kern, task, label, s_in, cmd, referee, ill_rule=True)
        errs.append(err)
        loaded = ref["f_pt"].abs().sum(-1) > 0
        for name, m in masks.items():
            share = float(loaded[:, m].any(1).float().mean())
            print(f"[check] {task} {label}: {name} loaded in {100 * share:.1f} % of the envs")
            if share < 0.9:
                fail(f"{task} {label}: {name} loaded in only {100 * share:.1f} % of the envs")
    plane = megakernel.pack(plan, settled, cmd)
    kern.launch(plane, 5)
    same_bits(kern, task, "settled", plane, 5)
    occ = occupancy_line(kern, task)
    k_ms = event_ms(lambda: kern.launch(plane, 5), 20)
    p_ms = event_ms(lambda: kern.plain(settled, cmd, 5), 5)
    nbytes, ops, counts = megakernel.work(plan, settled, cmd, 5)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    print(f"[time] {task} settled: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops} ops -> "
          f"{ops_ms:.5f} ms; points {counts})", flush=True)
    return dict(stack_max_abs_err=max(errs), stack_ms=k_ms, stack_plain_ms=p_ms,
                stack_bound_ms=max(bytes_ms, ops_ms), stack_slice_bytes=occ["slice_bytes"],
                stack_envs_per_sm=occ["envs_per_sm"])


def occupancy_line(kern, task):
    """Print and return the scene's slice and resident envs per SM."""
    floats, resident = kern.occupancy()
    print(f"[time] {task}: slice {4 * floats} B of shared memory an env, {resident} envs "
          "resident per SM", flush=True)
    return dict(slice_bytes=4 * floats, envs_per_sm=resident)


def same_bits(kern, task, label, plane, n_sub):
    """Two launches on one plane must give identical outputs."""
    import torch

    a, b = kern.launch(plane, n_sub), kern.launch(plane, n_sub)
    R = kern.plan.R_out
    same = torch.equal(a[:, :R].view(torch.int32), b[:, :R].view(torch.int32))
    print(f"[check] {task} {label}: two launches on one plane bit-identical: {same}")
    if not same:
        fail(f"{task} {label}: two launches on one plane differ")


def _outputs(state, aux):
    return {n: getattr(state, n) for n in TOL} | {n: aux[n] for n in AUX_TOL}


def _env_err(a, b):
    """Largest |a - b| of each env, in float64."""
    return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(1)


def compare_step(kern, task, label, sim, cmd, referee, ill_rule=False, kinds=None, n_steps=5,
                 per_env=False):
    """One launch of ``n_steps`` sim steps (a control step: 5 on the
    manipulation scenes, 4 on the control suite's) through the kernel and
    the plain step; fails where ``disagreement`` finds any. Returns the
    largest error, the largest over the envs held in full, and the plain
    step's outputs."""
    max_err, held_err, ref, worst = disagreement(kern, task, label, sim, cmd, referee, ill_rule,
                                                 kinds, n_steps, per_env)
    if worst:
        fail(f"{task} {label}: kernel disagrees with the plain step: " + "; ".join(worst))
    return max_err, held_err, ref


def disagreement(kern, task, label, sim, cmd, referee, ill_rule=False, kinds=None, n_steps=5,
                 per_env=False):
    """``compare_step``'s counts. Every env outside the mask ``referee``
    (K,) must agree within the tolerances. The envs in it are
    ill-conditioned (see the contact states in ``kernel_phase``): at most
    CONTACT_SHARE of them may disagree, and the kernel must be no further
    from a float64 plain step there than the float32 plain step is (1.5
    times as many envs beyond its tolerances, plus 8). With ``ill_rule``
    the share counts only the refereed envs where the float32 plain step
    itself stays within the tolerances of the float64 step (the in-hand
    scenes: a light object on 16 capsules leaves them in 7-14 % of the
    envs, in the plain step too). With ``per_env`` the refereed envs are
    held one by one instead: in each, field by field, the kernel should be
    no further from the float64 step than REFEREE_FACTOR times the larger
    of the plain step's distance from it and the tolerance, and it may be
    further in no more envs than twice those where chance takes the plain
    step as far from the kernel's, plus 1 % of the refereed envs (at least
    2): float32 rounding in a stiff contact puts either step several times
    further than the other in 0.5-3 % of the envs. The control suite's floor
    contacts take this rule: 1.6 kN forces against a 5e-3 tolerance take
    both float32 steps beyond the float64 step's in most envs, so that a
    count of such envs holds nothing. ``kinds``: named (K,) masks of refereed
    envs, each with its own counts of envs beyond the tolerances of the
    plain and float64 steps printed. Returns the largest error, the largest
    over the envs held in full, the plain step's outputs and what
    disagrees (empty where nothing does)."""
    import torch

    k = sim.qpos.shape[0]
    got = _outputs(*kern(sim, cmd, n_steps))
    ref = _outputs(*kern.plain(sim, cmd, n_steps))
    # the fields this scene has (no free-body fields in a robot-only scene)
    fields = {n: tol for n, tol in (TOL | AUX_TOL).items() if got[n][0].numel()}
    n_ref = int(referee.sum())
    if n_ref:
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            f64 = _outputs(*kern.plain(as64(sim), as64(cmd), n_steps))
        finally:
            torch.set_default_dtype(prev)
    torch.cuda.synchronize()
    shared = referee
    if n_ref and ill_rule:
        ill = torch.zeros_like(referee)
        for name, tol in fields.items():
            ill |= _env_err(ref[name], f64[name]) > tol
        shared = referee & ~ill
        print(f"[check] {task} {label}: the float32 plain step leaves the float64 step's "
              f"tolerances in {int((ill & referee).sum())} of {n_ref} refereed envs")
    max_err, held_err, worst = 0.0, 0.0, []
    for name, tol in fields.items():
        if not torch.isfinite(got[name]).all():
            worst.append(f"kernel output {name} is not finite")
            continue
        e = _env_err(got[name], ref[name])
        beyond = e > tol
        err, n_strict = float(e.max()), int((beyond & ~referee).sum())
        max_err = max(max_err, err)
        e_held = float(e[~referee].max()) if n_ref < k else 0.0
        held_err = max(held_err, e_held)
        line = (f"[check] {task} {label} {name}: max |kernel - plain| = {err:.3e} (tol "
                f"{tol:g}, max |plain| {float(ref[name].abs().max()):.3e}), median env "
                f"{float(e.median()):.3e}, envs beyond tol {n_strict} of "
                f"{k - n_ref} held in full (max {e_held:.3e})")
        if n_strict:
            worst.append(f"{name}: {n_strict} envs held in full beyond tol {tol:g}")
        if n_ref:
            d_k, d_p = _env_err(got[name], f64[name]), _env_err(ref[name], f64[name])
            k64_all, p64_all = d_k > tol, d_p > tol
            k64, p64 = int((k64_all & referee).sum()), int((p64_all & referee).sum())
            if per_env:
                # the kernel's distance from the float64 step over the
                # plain step's, and the mirror (the plain step's over the
                # kernel's: how far chance alone takes one float32 step)
                r_k = (d_k / d_p.clamp(min=tol))[referee]
                r_p = (d_p / d_k.clamp(min=tol))[referee]
                n_out, n_mirror = int((r_k > REFEREE_FACTOR).sum()), int((r_p > REFEREE_FACTOR).sum())
                q = torch.quantile(r_k, torch.tensor([0.5, 0.99], device=r_k.device,
                                                     dtype=r_k.dtype)).tolist()
                line += (f", {int((beyond & referee).sum())} of {n_ref} refereed beyond it; "
                         f"|kernel - float64| / max(|plain - float64|, tol) over the "
                         f"refereed envs: median {q[0]:.3f}, 99th percentile {q[1]:.3f}, max "
                         f"{float(r_k.max()):.3f}, beyond {REFEREE_FACTOR:g} in {n_out} (the "
                         f"plain step's over the kernel's: max {float(r_p.max()):.3f}, beyond "
                         f"{REFEREE_FACTOR:g} in {n_mirror}); beyond "
                         f"tol of the float64 step: kernel {k64}, plain {p64}")
                if n_out > 2 * n_mirror + max(2, 0.01 * n_ref):
                    worst.append(f"{name}: {n_out} refereed envs more than {REFEREE_FACTOR:g} "
                                 f"times further from the float64 step than the plain step "
                                 f"(the plain step so far from it: {n_mirror})")
            else:
                n_out = int((beyond & shared).sum())
                line += (f", {n_out} of {int(shared.sum())} refereed (max "
                         f"{float(e[referee].max()):.3e})"
                         f"{' (plain step within the float64 tolerances)' if ill_rule else ''}; "
                         f"beyond tol of the float64 step: kernel {k64}, plain {p64} refereed; "
                         f"kernel {int((k64_all & ~referee).sum())}, plain "
                         f"{int((p64_all & ~referee).sum())} held in full")
                if n_out > CONTACT_SHARE * int(shared.sum()) or k64 > 1.5 * p64 + 8:
                    worst.append(f"{name}: {n_out} refereed envs beyond tol of the plain step, "
                                 f"{k64} (plain: {p64}) beyond tol of the float64 step")
            for kind, m in (kinds or {}).items():
                line += (f"; {kind}: {int((beyond & m).sum())} of {int(m.sum())} beyond tol, "
                         f"of the float64 step kernel {int((k64_all & m).sum())}, plain "
                         f"{int((p64_all & m).sum())}")
        print(line)
    return max_err, held_err, ref, worst


def touched_in_step(kern, sim, cmd, n):
    """(K,) envs in which some point carries force in any of ``n`` sim
    steps of the plain step, run one sim step at a time (its ``f_pt`` is the
    last substep's only)."""
    import torch

    hit = torch.zeros(sim.qpos.shape[0], dtype=torch.bool, device=sim.qpos.device)
    for _ in range(n):
        sim, aux = kern.plain(sim, cmd, 1)
        hit |= (aux["f_pt"].abs().sum(-1) > 0).any(1) | (sim.contact_lam > 0).any(1)
    return hit


def forest_settle(env, kern, cst, ccmd, task, limit_gate):
    """A robot-only scene's settle: 10 control steps of the contact states
    through the kernel alone, under their own command. Prints, for each
    articulated object's dof, the share of envs in its open-limit band
    (within 0.01 of the upper limit, or past it: the limit spring acts);
    with ``limit_gate`` that share must be nonzero. Returns the first dof's
    share."""
    import torch

    sim = cst.sim
    for _ in range(10):
        sim, _aux = kern(sim, ccmd, 5)
    if not (torch.isfinite(sim.qpos).all() and torch.isfinite(sim.qvel).all()):
        fail(f"{task} settle from the contact states produced non-finite state")
    shares = []
    for name, dofs in env.model.art_dof_index.items():
        for d in dofs:
            hi = float(env.model.robot_qlim[d, 1])
            share = float((sim.qpos[:, d] >= hi - 0.01).float().mean())
            shares.append(share)
            print(f"[check] {task} settle: {env.model.robot.joint_names[d]} in its open-limit "
                  f"band (>= {hi:g} - 0.01) in {100 * share:.1f} % of the envs after 10 control "
                  f"steps from the contact states; range [{float(sim.qpos[:, d].min()):.4f}, "
                  f"{float(sim.qpos[:, d].max()):.4f}]")
    if limit_gate and not shares[0] > 0:
        fail(f"{task}: no env's object reached its joint-limit band")
    return shares[0]


def art_branches(env, plan, cst, loaded, depth):
    """What must carry force in the articulated contact states (fingers
    pressing the lid, the handle or the drawer, where the env index modulo
    4 is not 3): the box_box_corners points with a robot link on each side
    (the robot's tree and the object's). Prints the share of envs with
    such points loaded."""
    import torch

    from maniskill_tpu_torch.physics.megakernel import _FNS

    dev = loaded.device
    cross = torch.as_tensor((plan.pra >= 0) & (plan.prb >= 0)
                            & (plan.pfn == _FNS.index("box_box_corners")), device=dev)
    press = torch.arange(loaded.shape[0], device=dev) % 4 != 3
    held = loaded[:, cross].any(1)
    lam_t = cst.sim.contact_lam_t.abs().sum(-1) > 0
    print(f"[check] {env.env_id} K={loaded.shape[0]} contact: cross-tree box_box_corners "
          f"points loaded in {100 * float(held.float().mean()):.1f} % of the envs "
          f"({100 * float(held[press].float().mean()):.1f} % of the pressing envs; "
          f"{int(loaded[:, cross].sum())} points)")
    return {
        "cross-tree box_box_corners loaded (pressing envs)": held[press],
        "friction lam_t nonzero (cross-tree, pressing envs)": lam_t[press][:, cross].any(1),
    }


def loaded_in_step(kern, sim, cmd, n):
    """(K, P) points that carry force in any of ``n`` sim steps of the
    plain step (run one sim step at a time: its ``f_pt`` is the last
    substep's only), or hold a load after one."""
    import torch

    hit = torch.zeros_like(sim.contact_lam, dtype=torch.bool)
    for _ in range(n):
        sim, aux = kern.plain(sim, cmd, 1)
        hit |= (aux["f_pt"].abs().sum(-1) > 0) | (sim.contact_lam > 0)
    return hit


def planted_faults(env, task, cst):
    """The control suite's referee rule against K2 with a fault planted in
    its static tables: each point's friction coefficient 1 % high, or the
    normal impulse gain of the scene's last pair function's points (the
    humanoid's plane_sphere, the hopper's plane_capsule) 1 % high. On the
    contact states each must fail ``disagreement``'s ``per_env`` rule;
    prints, per fault, the fields that caught it and in how many envs."""
    import numpy as np
    import torch

    from maniskill_tpu_torch.physics import megakernel

    k = cst.sim.qpos.shape[0]
    every = torch.ones(k, dtype=torch.bool, device="cuda")
    last = env.model.pair_groups[-1][0].__name__
    for fault, table, rows in (("friction 1 % high", "cmu", slice(None)),
                               (f"{last} normal gain 1 % high", "dn0",
                                env.kernel.plan.pfn == megakernel._FNS.index(last))):
        bad = megakernel.MegaKernel(env.model)
        planted = getattr(bad.plan, table).copy()
        planted[rows] *= np.float32(1.01)
        setattr(bad.plan, table, planted)
        *_, worst = disagreement(bad, task, f"contact, {fault}", cst.sim, cst.cmd, every,
                                 n_steps=env.sim_steps_per_control, per_env=True)
        print(f"[check] {task} planted fault, {fault}: caught by "
              f"{'; '.join(worst) if worst else 'nothing'}", flush=True)
        if not worst:
            fail(f"{task}: the referee rule passes a kernel with {fault}")


def control_phase(mtt, engine, megakernel, task, k=K_CHECK):
    """Phase 2 for a control-suite scene at ``k`` envs (one control step:
    4 sim steps of 2 substeps, h = 5 ms): K2 against its plain step from
    reset states under the command of a random action (``random_torques``:
    normal(0, 0.6) clipped, MPPI's draw at the bench sigma; Cartpole: a
    uniform slider action); for a robot on the floor, from
    ``contact_state`` states (standing in even envs; on a side or upside
    down in odd ones; small random torques), where plane_capsule must
    carry force in the standing envs and plane_sphere in the upside-down
    ones (where the scene has it), with friction. Cartpole's envs are held
    in full. The floor robots' are all refereed one by one (``compare_step``,
    ``per_env``), in the air too: the humanoid's 27-dof tree
    under the bench torques (qvel up to 100 rad/s) puts both float32 steps
    a median 4e-5 from a float64 step in qvel, and the kernel and the
    plain step differ beyond 2e-4 in 18 of 4,096 reset envs, none touching
    anything; on the floor both leave the float64 step's f_pt tolerance in
    two thirds of the envs (PERF.md section 6). On the contact states the
    referee must also catch a kernel with a fault planted in its tables
    (``planted_faults``). Then a 10-control-step
    settle through the kernel alone from the contact states (Cartpole: the reset
    states), finite, nothing more than 5 cm into the floor, and one more
    step against the plain step from there. Times the kernel and the plain
    step and counts the bound on the contact states (Cartpole: the
    settled states); the largest error returned is the reset and contact
    states' (Cartpole: reset and settled), as ``kernel_phase``'s."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms
    from maniskill_tpu_torch.physics.model import tree_map

    env = mtt.make(task, num_envs=k, reward_mode="dense")
    task = f"{task} K={k}"
    env.reset(seed=0)
    kern, plan = env.kernel, env.kernel.plan
    n = env.sim_steps_per_control
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    st = env._state
    floor = plan.P > 0
    if floor:
        st = env.random_torques(st, gen)
    else:
        a = torch.rand((k, env.action_dim), generator=gen, device="cuda") * 2 - 1
        st = st.replace(cmd=env.agent.controller.set_action(st.cmd, st.sim.qpos, a))
    print(f"[check] {task}: nq {env.model.nq}, G {len(env.model.geoms)}, P {plan.P}, "
          f"n_all {plan.n_all}; |qf| up to {float(st.cmd.qf.abs().max()):.2f}")

    def compare(label, sim, cmd):
        kk = sim.qpos.shape[0]
        if not floor:  # Cartpole: every env held in full
            return compare_step(kern, task, label, sim, cmd,
                                torch.zeros(kk, dtype=torch.bool, device="cuda"), n_steps=n)
        touch = touched_in_step(kern, sim, cmd, n)
        print(f"[check] {task} {label}: every env refereed; a point carries force within the "
              f"step in {int(touch.sum())} of {kk}")
        return compare_step(kern, task, label, sim, cmd,
                            torch.ones(kk, dtype=torch.bool, device="cuda"), per_env=True,
                            kinds={"touching": touch, "in the air": ~touch}, n_steps=n)

    err_reset, held_reset, _ = compare("reset", st.sim, st.cmd)
    errs = [err_reset]
    if floor:
        cst = env.contact_state(env._state, gen)
        err_contact, _, cref = compare("contact", cst.sim, cst.cmd)
        errs.append(err_contact)
        loaded = loaded_in_step(kern, cst.sim, cst.cmd, n)
        pfn = torch.as_tensor(plan.pfn, device="cuda")
        idx = torch.arange(k, device="cuda")
        print(f"[check] {task} contact: {int(loaded.sum())} points loaded in the step "
              f"({float(loaded.sum(1).float().mean()):.2f} per env)")
        branches = {"plane_capsule loaded (standing envs)":
                    loaded[idx % 2 == 0][:, pfn == megakernel._FNS.index("plane_capsule")].any(1),
                    "friction lam_t nonzero":
                    (cref["contact_lam_t"].abs().sum(-1) > 0).any(1)}
        sphere = pfn == megakernel._FNS.index("plane_sphere")
        if bool(sphere.any()):
            branches["plane_sphere loaded (upside-down envs)"] = loaded[idx % 4 == 3][:, sphere].any(1)
        for label, holds in branches.items():
            share = float(holds.float().mean())
            print(f"[check] {task} contact: {label} in {100 * share:.1f} % of its envs")
            if share < 0.5:
                fail(f"{task} contact states do not exercise {label} "
                     f"(only {100 * share:.1f} %)")
        planted_faults(env, task, cst)
        s_in, c_in = cst.sim, cst.cmd
    else:
        s_in, c_in = st.sim, st.cmd
    # settle: 10 control steps through the kernel alone, then one more
    # against the plain step. A root of three hinges (the humanoid's, the
    # ant's <freejoint>: z, y, x) is singular where the middle one reaches
    # a quarter turn (lying on the back or the front): the outer two align,
    # the mass matrix loses a rank but for the chain's 1e-6 kg links, and
    # the float32 step, the JAX package's too, drives the root's velocities
    # to 1e3 rad/s and then to non-finite values (ROADMAP Queue C). The
    # settle launches one sim step at a time and leaves out the envs that
    # come within 0.17 rad of it, or turn non-finite within 0.35 rad of it
    sim = s_in
    names = env.model.robot.joint_names
    hinges = [i for i, nm in enumerate(names)
              if nm.startswith("root") and env.model.robot.joint_type[i] == 0]
    near = torch.zeros(k, dtype=torch.bool, device="cuda")
    for _ in range(10 * n):
        if len(hinges) == 3:
            c_prev = torch.cos(sim.qpos[:, hinges[1]]).abs()
            near |= c_prev < 0.17
        sim, _aux = kern(sim, c_in, 1)
        if len(hinges) == 3:
            near |= ~torch.isfinite(sim.qpos).all(1) & (c_prev < 0.34)
    if len(hinges) == 3:
        near |= torch.cos(sim.qpos[:, hinges[1]]).abs() < 0.17
    keep = ~near
    print(f"[check] {task} settle: {int(near.sum())} of {k} envs came within 0.17 rad of the "
          f"root chain's singularity (left out); non-finite among them "
          f"{int((~torch.isfinite(sim.qpos).all(1) & near).sum())}")
    if int(keep.sum()) < k // 2:
        fail(f"{task}: {int(near.sum())} of {k} envs reached the root chain's singularity")
    sim, c_set = (tree_map(lambda x: x[keep], x) for x in (sim, c_in))
    if not (torch.isfinite(sim.qpos).all() and torch.isfinite(sim.qvel).all()):
        fail(f"{task} settle produced non-finite state")
    if floor:
        depth = engine.compute_contacts(env.model, sim,
                                        *engine.robot_fk(env.model, sim.qpos)[:2])[2]
        deepest = float(depth.max())
        print(f"[check] {task} settle: deepest point {1e3 * deepest:.2f} mm into the floor "
              "after 10 control steps")
        if deepest > 0.05:
            fail(f"{task}: a robot sank {deepest:.3f} m into the floor")
    err_settled, _, _ = compare("settled", sim, c_set)
    if not floor:  # Cartpole's kernels-line error: reset and settled
        errs.append(err_settled)
        s_in = sim
    n_sub = n * env.model.params.substeps
    occ = occupancy_line(kern, task)
    label = "contact" if floor else "settled"
    plane = megakernel.pack(plan, s_in, c_in)
    kern.launch(plane, n_sub)
    same_bits(kern, task, label, plane, n_sub)
    k_ms = event_ms(lambda: kern.launch(plane, n_sub), 20)
    p_ms = event_ms(lambda: kern.plain(s_in, c_in, n), 5)
    nbytes, ops, counts = megakernel.work(plan, s_in, c_in, n_sub)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    print(f"[time] {task} {label}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops} ops "
          f"-> {ops_ms:.5f} ms; points {counts})", flush=True)
    return dict(max_err=max(errs), max_err_held=held_reset, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations") | occ


def kernel_phase(mtt, engine, megakernel, task, branches, k=K_CHECK, settle_band=(-0.005, 0.005),
                 contact_cmd="perturbed", inhand=False, limit_gate=False):
    """Phase 2 for one task at ``k`` envs: K2 against its plain step,
    settle, time, bound. ``settle_band``: how far (m) a free body that
    starts apart may end from its starting height after 10 control steps.
    ``contact_cmd``: the contact states' command, their own with perturbed
    targets (``"perturbed"``) or their own (``"own"``: the arm holds and
    the gripper shuts). In PlugCharger's and RollBall's grasps targets
    moved by 0.05 rad make the plain float32 step itself leave the
    tolerances of a float64 step in 9-15 % of the envs (CPU, K=512; PERF.md
    section 6), beyond the referee rule's share, so those take their own.
    ``inhand``: the Allegro scenes, where the object is dropped onto the
    fingers at reset. Reset envs whose object touches nothing in the step
    are held in full, the rest refereed; the referee's share counts only
    envs where the float32 plain step stays within the float64 step's
    tolerances (``compare_step``); the settle check asks that 80 % of the
    objects stay on the hand (over its drop height) instead of a band.
    Robot-only scenes (F=0: the articulated tasks) referee the reset envs
    where a point carries force within the step, as the in-hand scenes do
    (without the share rule's restriction), and settle from their contact
    states instead (``forest_settle``; ``limit_gate``: an object must
    reach its open-limit band)."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms

    ill_rule = inhand
    env = mtt.make(task, num_envs=k, reward_mode="dense")
    task = f"{task} K={k}"
    env.reset(seed=0)
    kern, plan = env.kernel, env.kernel.plan
    st = env._state
    if "model_id" in st.extras:  # per-env objects: every library object present
        n_models = len(env._lib) if hasattr(env, "_lib") else len(env.MODELS)
        seen = torch.bincount(st.extras["model_id"].long(), minlength=n_models)
        print(f"[check] {task} reset: envs per library object {seen.tolist()}")
        if not bool((seen > 0).all()):
            fail(f"{task}: reset states miss a library object: {seen.tolist()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def perturbed(cmd):
        return cmd.replace(target_qpos=cmd.target_qpos + 0.05 * torch.randn(
            cmd.target_qpos.shape, generator=gen, device="cuda"))

    def compare(label, sim, cmd, referee, kinds=None):
        return compare_step(kern, task, label, sim, cmd, referee, ill_rule, kinds)

    # a) reset states: cubes rest on the table, the hand is far from them;
    # every env must agree. StackCube's placement rule (the JAX package's:
    # centres at least sqrt(2) half + 1 mm apart) lets the two 4 cm cubes
    # start interpenetrating, up to ~2 cm deep, in about a fifth of the
    # envs, and a few of those are as ill-conditioned as the contact states
    # below; only those envs take the contact states' rule
    # (two free bodies: a pair of one body with itself, as PlugCharger's
    # prong against its own base at zero depth, moves nothing)
    free_free = torch.as_tensor((plan.pfa >= 0) & (plan.pfb >= 0) & (plan.pfa != plan.pfb),
                                device="cuda")
    depth0 = engine.compute_contacts(
        env.model, st.sim, *engine.robot_fk(env.model, st.sim.qpos)[:2])[2]
    overlap = (depth0[:, free_free] > 0).any(1)
    print(f"[check] {task} reset: {int(overlap.sum())} of {k} envs start with "
          "free bodies interpenetrating")
    cmd = perturbed(st.cmd)
    kinds = None
    if inhand:
        overlap = touched_in_step(kern, st.sim, cmd, 5)
        print(f"[check] {task} reset: the object touches the hand within the step in "
              f"{int(overlap.sum())} of {k} envs (refereed)")
    elif env.model.n_free == 0:
        # robot-only scenes: the JAX reset's own draws start the Panda's
        # hand or fingers inside FoldSuitcase's open lid in about 37 % of
        # the envs, every container model alike (ROADMAP Queue C), and the
        # perturbed targets bring them into the lid within the step in
        # about 10 % more. Both are stiff contacts: the float32 plain step
        # itself leaves the float64 step's tolerances in a few envs of
        # each kind, and so does the kernel (the compare lines print
        # both). Envs in which a point carries force within the step take
        # the contact states' rule, as the in-hand scenes' do; every other
        # env is held in full
        cross = torch.as_tensor((plan.pra >= 0) & (plan.prb >= 0), device="cuda")
        inside = (depth0[:, cross] > 0).any(1)
        overlap = touched_in_step(kern, st.sim, cmd, 5) | inside
        print(f"[check] {task} reset: {int(overlap.sum())} of {k} envs refereed: "
              f"{int(inside.sum())} start with a robot link inside the object, "
              f"{int((overlap & ~inside).sum())} more carry force within the step")
        kinds = {"start inside": inside, "touch within the step": overlap & ~inside}
    err_reset, held_reset, _ = compare("reset", st.sim, cmd, referee=overlap, kinds=kinds)
    # b) states in contact: every pair function carries force. Stiff
    # contacts amplify float32 rounding, and a force law with thresholds
    # (margin, load gate, friction cone) flips in a few envs, so the plain
    # float32 step itself leaves the tolerances against a float64 step
    # there; the kernel must agree with the plain step in all but
    # CONTACT_SHARE of the envs, and be no further from the float64 step
    # than the plain step is (1.5 x its count of envs beyond tol, plus 8)
    cst = env.contact_state(st, gen)
    ccmd = perturbed(cst.cmd) if contact_cmd == "perturbed" else cst.cmd
    err_contact, _, cref = compare("contact", cst.sim, ccmd,
                                referee=torch.ones(k, dtype=torch.bool, device="cuda"))
    loaded = cref["f_pt"].abs().sum(-1) > 0  # (K, P)
    depth = engine.compute_contacts(
        env.model, cst.sim, *engine.robot_fk(env.model, cst.sim.qpos)[:2])[2]
    print(f"[check] {task} contact: {int(loaded.sum())} loaded points of {loaded.numel()} "
          f"({float(loaded.sum(1).float().mean()):.2f} per env)")
    for label, holds in branches(env, plan, cst, loaded, depth).items():
        share = float(holds.float().mean())
        print(f"[check] {task} contact: {label} in {100 * share:.1f} % of its envs")
        if share < 0.5:
            fail(f"{task} contact states do not exercise {label} (only {100 * share:.1f} %)")

    # settle: 10 control steps through the kernel alone; cubes that start
    # apart stay on the table
    sim = st.sim
    for _ in range(10):
        sim, _aux = kern(sim, st.cmd, 5)
    if not (torch.isfinite(sim.qpos).all() and torch.isfinite(sim.free_pose).all()):
        fail(f"{task} settle run produced non-finite state")
    if inhand:
        held = float((sim.free_pose[:, 0, 2] > env.drop_height).float().mean())
        print(f"[check] {task} settle: the object on the hand after 10 control steps in "
              f"{100 * held:.1f} % of the envs")
        if held < 0.8:
            fail(f"{task}: only {100 * held:.1f} % of the objects stayed on the hand")
        settle_band = None
    dz = (sim.free_pose[..., 2] - st.sim.free_pose[..., 2])[~overlap]
    if env.model.n_free == 0:  # robot-only: no free body to settle
        settle_band = None
        limit_share = forest_settle(env, kern, cst, ccmd, task, limit_gate)
    if settle_band is not None:
        if not bool(((dz > settle_band[0]) & (dz < settle_band[1])).all()):
            fail(f"{task}: free bodies did not settle: height change in [{float(dz.min()):.4f}, "
                 f"{float(dz.max()):.4f}] m, allowed {settle_band}")
        print(f"[check] {task} settle: height change in [{float(dz.min()):.5f}, "
              f"{float(dz.max()):.5f}] m in the {int((~overlap).sum())} envs whose bodies start "
              "apart")

    # kernel time per launch (one control step: 5 sim steps of the scene's
    # substeps), its bound and the plain step's time, on both input sets;
    # the kernels line reports the contact states
    n_sub = 5 * env.model.params.substeps
    occ = occupancy_line(kern, task)
    timing = {}
    for label, (s_in, c_in) in dict(reset=(st.sim, cmd), contact=(cst.sim, ccmd)).items():
        plane = megakernel.pack(plan, s_in, c_in)
        kern.launch(plane, n_sub)
        same_bits(kern, task, label, plane, n_sub)
        k_ms = event_ms(lambda: kern.launch(plane, n_sub), 20)
        p_ms = event_ms(lambda: kern.plain(s_in, c_in, 5), 5)
        nbytes, ops, counts = megakernel.work(plan, s_in, c_in, n_sub)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        timing[label] = (k_ms, p_ms, bytes_ms, ops_ms)
        print(f"[time] {task} {label}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops} ops "
              f"-> {ops_ms:.5f} ms; points {counts})", flush=True)
    k_ms, p_ms, bytes_ms, ops_ms = timing["contact"]
    out = dict(max_err=max(err_reset, err_contact), max_err_held=held_reset, ms=k_ms,
               plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations") | occ
    if env.model.n_free == 0:
        out["limit_band_share"] = limit_share
    return out


def ragged_phase(mtt):
    """K2 against its plain step on PickCube reset states at K=1 (the
    iLQR rollouts' width: one warp on the card) and at K=4,097 (one env
    past a whole number of blocks), targets perturbed, every env held to
    the tolerances. Returns the largest error."""
    import torch

    worst = 0.0
    for k in (1, K_CHECK + 1):
        env = mtt.make("PickCube-v1", num_envs=k, reward_mode="dense")
        env.reset(seed=0)
        st = env._state
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05 * torch.randn(
            st.cmd.target_qpos.shape, generator=gen, device="cuda"))
        launches = env.kernel.launches
        err, _, _ = compare_step(env.kernel, f"PickCube-v1 K={k}", "reset", st.sim, cmd,
                              referee=torch.zeros(k, dtype=torch.bool, device="cuda"))
        if env.kernel.launches != launches + 1:
            fail(f"PickCube-v1 K={k}: the check did not launch the kernel once")
        worst = max(worst, err)
    return worst


def seam_phase(mtt, ILQR, ILQRConfig):
    """Phase 3: derivatives of one StackCube control step through the
    kernel's seam against those of the plain step, on the card."""
    import torch

    envs = {b: mtt.make("StackCube-v1", num_envs=K_SEAM, reward_mode="dense", sim_backend=b)
            for b in ("auto", "torch")}
    for e in envs.values():
        e.reset(seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    st = envs["auto"].contact_state(envs["auto"]._state, gen)
    il = {b: ILQR(e, ILQRConfig(horizon=1)) for b, e in envs.items()}
    x = il["auto"].reduce(st.sim).contiguous()
    u = 0.3 * torch.randn((K_SEAM, 8), generator=gen, device="cuda")
    dx = torch.randn(x.shape, generator=gen, device="cuda")
    du = torch.randn(u.shape, generator=gen, device="cuda")
    gy = torch.randn(x.shape, generator=gen, device="cuda")
    gc = torch.randn((K_SEAM,), generator=gen, device="cuda")
    kern = envs["auto"].kernel
    out = {}
    for b, p in il.items():
        launches = kern.launches
        dy, dc = p.step_jvp(st, x, u, dx, du)
        xr, ur = x.clone().requires_grad_(), u.clone().requires_grad_()
        st2, c = p.step_cost(st.replace(sim=p.inject(st.sim, xr)), ur)
        torch.autograd.backward([p.reduce(st2.sim), c], [gy, gc])
        torch.cuda.synchronize()
        out[b] = dict(jvp_state=dy, jvp_cost=dc[:, None], vjp_x=xr.grad, vjp_u=ur.grad)
        if b == "auto" and kern.launches - launches != 2:
            fail(f"the seam's JVP and VJP launched the kernel {kern.launches - launches} "
                 "times, not 2 (one primal each)")
    worst = 0.0
    for name in out["auto"]:
        a, r = out["auto"][name].double(), out["torch"][name].double()
        if not torch.isfinite(a).all():
            fail(f"seam {name}: not finite")
        rel = (a - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-6)
        n_out = int((rel > SEAM_REL_TOL).sum())
        worst = max(worst, float(rel.max()))
        print(f"[seam] {name}: max rel |seam - plain| {float(rel.max()):.3e}, median "
              f"{float(rel.median()):.3e}, envs beyond {SEAM_REL_TOL:g}: {n_out} of {K_SEAM} "
              f"(max |plain| {float(r.abs().max()):.3e})")
        if n_out:
            fail(f"seam {name}: {n_out} envs disagree with the plain step")
    return worst


def mppi_phase(mtt, megakernel, MPPI, MPPIConfig, task, obs_dim, min_finite=1.0,
               bound_every=PATH_BOUND_EVERY, control_mode=None, profile=True, **overrides):
    """Phases 4 and 5: MPPI on one task at its env class's ``MPPI_CONFIG``
    (``overrides``: MPPIConfig keyword arguments that replace it), one
    warm-up and TIMED_SOLVES timed solves, K2's launches counted and its
    device time read around them. At least the share ``min_finite`` of
    the last solve's rollouts must end with a finite return (MPPI gives
    the others zero weight), and the nominal must be finite.
    Returns the launches, the kernel's mean device time per launch in the
    timed solves, and the mean bound of a launch, counted by
    ``megakernel.work`` on the inputs of every ``bound_every``-th launch
    of the warm-up solve (the rollouts' own states and commands).
    ``control_mode``: the env's (default: its first); under a task-space
    mode every rollout step's IK solve launches K1 once, counted and timed
    by CUDA events like K2 (``k1_launches``, ``k1_path_ms``). ``profile``:
    one more solve under torch.profiler (``profile_solve``)."""
    import torch
    from maniskill_tpu_torch.physics import solve_kernel

    env1 = mtt.make(task, num_envs=1, robot_init_qpos_noise=0.0, reward_mode="dense",
                    **({} if control_mode is None else dict(control_mode=control_mode)))
    ik = env1.agent.controller.needs_fk_aux
    env1.reset(seed=0)
    cfg = dict(type(env1).MPPI_CONFIG, **overrides)
    H, num_samples = cfg["horizon"], cfg["num_samples"]
    planner = MPPI(env1, MPPIConfig(**cfg))
    ps = planner.init(seed=0)
    kern = env1.kernel
    step, path_work, calls = kern.step, [], [0]

    def counted_step(sim, cmd, n_steps):
        if calls[0] % bound_every == 0:
            path_work.append(megakernel.work(kern.plan, sim, cmd,
                                             n_steps * env1.model.params.substeps)[:2])
        calls[0] += 1
        return step(sim, cmd, n_steps)

    kern.step = counted_step
    env1.kernel.launches = solve_kernel.launches = 0
    torch.cuda.synchronize()
    ps, info = planner.solve(ps, env1._state)
    torch.cuda.synchronize()
    del kern.step
    if solve_kernel.launches != (H if ik else 0):
        fail(f"warm-up solve launched K1 {solve_kernel.launches} times, not {H if ik else 0}")
    bytes_ms = statistics.mean(w[0] for w in path_work) / HBM_BYTES_PER_S * 1e3
    ops_ms = statistics.mean(w[1] for w in path_work) / FP32_OPS_PER_S * 1e3
    if env1.kernel.launches != H:
        fail(f"warm-up solve launched the kernel {env1.kernel.launches} times, not {H}")
    # the kernel's device time inside the timed solves: CUDA events around
    # each launch (no profiler), summed after the run
    spans, launch = [], env1.kernel.launch

    def timed_launch(plane, n_substeps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(plane, n_substeps)
        b.record()
        spans.append((a, b))
        return out

    k1_spans, k1_launch = [], solve_kernel.launch

    def timed_k1(A, b):
        a0 = torch.cuda.Event(enable_timing=True)
        b0 = torch.cuda.Event(enable_timing=True)
        a0.record()
        x = k1_launch(A, b)
        b0.record()
        k1_spans.append((a0, b0))
        return x

    env1.kernel.launch = timed_launch
    solve_kernel.launch = timed_k1
    t0 = time.perf_counter()
    try:
        for _ in range(TIMED_SOLVES):
            ps, info = planner.solve(ps, env1._state)
        torch.cuda.synchronize()
    finally:
        solve_kernel.launch = k1_launch
    dt = time.perf_counter() - t0
    del env1.kernel.launch
    kernel_busy_ms = sum(a.elapsed_time(b) for a, b in spans)
    launches, k1_launches = env1.kernel.launches, solve_kernel.launches
    if launches != H * (TIMED_SOLVES + 1):
        fail(f"main path launched the kernel {launches} times, not {H * (TIMED_SOLVES + 1)}")
    if k1_launches != (H * (TIMED_SOLVES + 1) if ik else 0):
        fail(f"main path launched K1 {k1_launches} times, not "
             f"{H * (TIMED_SOLVES + 1) if ik else 0}")
    returns = info["returns"]
    finite = float(torch.isfinite(returns).float().mean())
    if returns.shape != (num_samples,) or finite < min_finite:
        fail(f"MPPI returns finite in {100 * finite:.1f} % of the rollouts, "
             f"fewer than {100 * min_finite:.0f} %")
    if not bool(torch.isfinite(ps.nominal).all()):
        fail("MPPI nominal is not finite")
    obs, reward, *_ = env1.step(ps.nominal[0])
    if obs.shape != (1, obs_dim) or not bool(torch.isfinite(obs).all()):
        fail(f"env step after planning gave obs {tuple(obs.shape)}")
    rps = num_samples * TIMED_SOLVES / dt
    print(f"[main] {task} MPPI H={H} K={num_samples}: {rps:.1f} rollouts/s "
          f"({dt / TIMED_SOLVES:.3f} s/solve), best return {float(info['best_return']):.4f}, "
          f"finite returns {100 * finite:.1f} %, "
          f"kernel launches {launches} ({launches // (TIMED_SOLVES + 1)} per solve)", flush=True)
    print(f"[main] {task} kernel device time {kernel_busy_ms / TIMED_SOLVES:.3f} ms/solve "
          f"({len(spans)} launches timed by CUDA events, "
          f"{kernel_busy_ms / len(spans):.3f} ms per launch), "
          f"{100 * kernel_busy_ms / (dt * 1e3):.1f} % of the wall time; bound per launch on "
          f"the warm-up solve's inputs {max(bytes_ms, ops_ms):.5f} ms (bytes {bytes_ms:.5f} ms, "
          f"operations {ops_ms:.5f} ms, mean of {len(path_work)} launches: every "
          f"{bound_every}th of the warm-up solve's)", flush=True)
    out = dict(launches=launches, path_ms=kernel_busy_ms / len(spans),
               path_bound_ms=max(bytes_ms, ops_ms), rps=rps)
    if ik:
        k1_ms = sum(a.elapsed_time(b) for a, b in k1_spans)
        out |= dict(k1_launches=k1_launches, k1_path_ms=k1_ms / len(k1_spans))
        print(f"[main] {task} {control_mode}: K1 launches {k1_launches} "
              f"({k1_launches // (TIMED_SOLVES + 1)} per solve), device time "
              f"{k1_ms / TIMED_SOLVES:.3f} ms/solve ({k1_ms / len(k1_spans):.4f} ms per launch, "
              f"CUDA events), {100 * k1_ms / (dt * 1e3):.2f} % of the wall time", flush=True)
    if profile:
        profile_solve(planner, ps, env1._state)
    return out


def episode_phase(mtt, planners):
    """Phase 5f: PushCube-v1 episodes at its ``MPPI_CONFIG`` (H=20, K=2048),
    seed 0, EPISODE_STEPS control steps: ``run_episode_device`` (each
    control step one CUDA graph, replayed under
    ``set_sync_debug_mode("error")``) and ``run_episode(stop_on_success=
    False)`` (the host loop). The first control step's actions must agree
    within EPISODE_TOL and the device episode must end with the cube nearer
    its goal than it started. K2's wrapper counts the device episode's
    warm-up step and its capture (H + 1 calls each: the rollouts' and the
    env step's); the replays launch K2 without the wrapper, so the captured
    graph's kernel nodes are read from the graph itself (libcuda), and the
    graph must hold H + 1 K2 nodes, each launched once a replay. A second
    device episode from the same seed runs PROFILED_STEPS replays under
    torch.profiler for the replays' device busy time and K2's share of it
    (the profiler drops some of a graph's kernel records, 0-10 % in a
    profile on an H100, so its counts are printed, not gated). Then one
    device episode at BASELINE config #1's literal shape (H=30, K=256),
    whose actions and return must be finite. Returns the device episode's
    numbers for the kernels line."""
    import numpy as np
    import torch

    env = mtt.make("PushCube-v1", num_envs=1, obs_mode="none", reward_mode="dense")
    cfg = planners.MPPIConfig(**type(env).MPPI_CONFIG)
    planner = planners.MPPI(env, cfg)
    H = cfg.horizon

    def cube_to_goal():
        sim = env._state.sim
        return float(torch.linalg.norm(sim.free_pose[0, env.cube, :2]
                                       - sim.kin_pose[0, env.goal_region, :2]))

    env.reset(seed=0)
    d0 = cube_to_goal()
    env.kernel.launches = 0
    stats = {}
    dev = planners.run_episode_device(env, planner, seed=0, max_steps=EPISODE_STEPS, stats=stats)
    dev_launches = env.kernel.launches
    kernels = stats["graph_kernels"] or {}
    k2_nodes = sum(c for name, c in kernels.items() if "mk_kernel" in name)
    graph_launches = k2_nodes * EPISODE_STEPS
    d_dev = cube_to_goal()
    env.kernel.launches = 0
    host = planners.run_episode(env, planner, seed=0, max_steps=EPISODE_STEPS,
                                stop_on_success=False)
    host_launches = env.kernel.launches
    d_host = cube_to_goal()
    err0 = float(np.abs(dev["actions"][0] - host["actions"][0]).max())
    n = dev["steps"]
    err_n = float(np.abs(dev["actions"][:n] - host["actions"][:n]).max())
    print(f"[episode] PushCube-v1 device loop (CUDA graph) H={H} K={cfg.num_samples}: "
          f"{dev['replan_hz']:.2f} control steps/s over {EPISODE_STEPS} replays, success "
          f"{dev['success']} at step {dev['steps']}, return {dev['episode_return']:.4f}, "
          f"cube-to-goal {d0:.4f} -> {d_dev:.4f} m; graph of {stats['graph_nodes']} nodes, "
          f"captured in {stats['capture_s']:.2f} s (with the warm-up step), "
          f"{dev_launches} K2 wrapper calls (warm-up and capture), {k2_nodes} K2 kernel "
          f"nodes in the graph ({graph_launches} K2 launches in the replays)", flush=True)
    print(f"[episode] PushCube-v1 host loop H={H} K={cfg.num_samples}: {host['replan_hz']:.2f} "
          f"plan steps/s (after the first), success {host['success']}, return over "
          f"{host['steps']} steps {host['episode_return']:.4f}, cube-to-goal {d0:.4f} -> "
          f"{d_host:.4f} m, {host_launches} K2 launches", flush=True)
    print(f"[episode] first action device vs host: max |diff| {err0:.3e}; over the device "
          f"episode's {n} steps {err_n:.3e}", flush=True)
    if err0 > EPISODE_TOL:
        fail(f"the device episode's first action differs from the host loop's by {err0:.3e}")
    if dev_launches != 2 * (H + 1):
        fail(f"K2's wrapper ran {dev_launches} times in the device episode's warm-up and "
             f"capture, not {2 * (H + 1)}")
    if k2_nodes != H + 1:
        fail(f"the graph holds {k2_nodes} K2 kernel nodes, not {H + 1} (its kernel nodes: "
             f"{stats['graph_kernels']})")
    if not (np.isfinite(dev["actions"]).all() and d_dev < d0):
        fail(f"the device episode did not bring the cube nearer its goal ({d0:.4f} -> "
             f"{d_dev:.4f} m)")
    # the replays' device time, from a profile of the replays of a second
    # device episode (the profiler slows the host, so the first episode's
    # rate is the one reported)
    prof = new_profile()
    prof_ep = planners.run_episode_device(env, planner, seed=0, max_steps=PROFILED_STEPS,
                                          around_replays=prof)
    rows = device_rows(prof)
    k2_rows = [r for r in rows if r[0].startswith("mk_kernel")]
    prof_k2 = sum(r[2] for r in k2_rows)
    graph_k2_us = sum(r[1] for r in k2_rows)
    busy_us = sum(r[1] for r in rows)
    prof_ops = sum(r[2] for r in rows)
    prof_wall_us = PROFILED_STEPS / prof_ep["replan_hz"] * 1e6
    k2_each_ms = busy_ms_per_replay = None  # null where not measured
    if busy_us <= 0:
        print("[episode] profile of the replays: not measured (no CUDA activity recorded)")
    else:
        k2_each_ms = graph_k2_us / max(prof_k2, 1) / 1e3
        busy_ms_per_replay = busy_us / PROFILED_STEPS / 1e3
        print(f"[episode] profile of {PROFILED_STEPS} replays: wall {prof_wall_us / 1e3:.1f} ms "
              f"(profiled), device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / prof_wall_us:.1f} %), {prof_ops} device ops recorded "
              f"({stats['graph_nodes'] * PROFILED_STEPS} graph nodes replayed, and "
              f"{3 * PROFILED_STEPS} output copies); K2 {prof_k2} "
              f"kernels recorded of {k2_nodes * PROFILED_STEPS}, {graph_k2_us / 1e3:.3f} ms "
              f"({k2_each_ms:.4f} ms each, "
              f"{100 * graph_k2_us / busy_us:.1f} % of the busy time)", flush=True)
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"[episode]   {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    # BASELINE config #1's literal shape: H=30, K=256
    planner1 = planners.MPPI(env, planners.MPPIConfig(horizon=30, num_samples=256, sigma=0.6,
                                                      temperature=0.3))
    stats1 = {}
    ep1 = planners.run_episode_device(env, planner1, seed=0, max_steps=EPISODE_STEPS,
                                      stats=stats1)
    print(f"[episode] PushCube-v1 device loop at BASELINE config #1 (H=30, K=256): "
          f"{ep1['replan_hz']:.2f} control steps/s, success {ep1['success']} at step "
          f"{ep1['steps']}, return {ep1['episode_return']:.4f}, graph of "
          f"{stats1['graph_nodes']} nodes captured in {stats1['capture_s']:.2f} s", flush=True)
    if not (np.isfinite(ep1["actions"]).all() and np.isfinite(ep1["episode_return"])):
        fail("the config #1 device episode is not finite")
    return dict(launches=dev_launches, graph_launches=graph_launches,
                graph_k2_ms_each=k2_each_ms, graph_busy_ms_per_replay=busy_ms_per_replay,
                episode_first_action_err=err0,
                episode_replan_hz=dev["replan_hz"], host_replan_hz=host["replan_hz"],
                graph_nodes=stats["graph_nodes"], capture_s=stats["capture_s"])


def cem_ilqr_phase(mtt, planners):
    """Phase 6: StackCube CEM + iLQR at BASELINE config #3."""
    import torch

    env = mtt.make("StackCube-v1", num_envs=1, reward_mode="dense")
    env.reset(seed=0)
    cfg = planners.CEMILQRConfig(
        cem=planners.CEMConfig(horizon=H_PLAN, num_samples=K_CEM, num_elites=ELITES,
                               iterations=CEM_ITERS, init_sigma=0.5),
        ilqr=planners.ILQRConfig(horizon=H_PLAN, iterations=ILQR_ITERS, action_penalty=1e-3))
    planner = planners.CEMILQR(env, cfg)
    # synchronized wall time of each stage and of iLQR's passes, read
    # through wrappers (per plan step: 1 + iterations rollouts at K=1, one
    # linearization at K = H (nx + nu) and one line search per iteration)
    spans = {"cem": [], "ilqr": [], "rollout": [], "linearize": [], "line_search": []}
    stages = [("cem", planner.cem, "solve"), ("ilqr", planner.ilqr, "solve")] + [
        (n, planner.ilqr, n) for n in ("rollout", "linearize", "line_search")]
    for name, stage, attr in stages:
        def timed(*a, _fn=getattr(stage, attr), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            spans[_name].append(time.perf_counter() - t0)
            return out
        setattr(stage, attr, timed)
    # launches per plan step: CEM iterations x H rollout steps (K=1024);
    # iLQR: the initial cost rollout (H), then per iteration the nominal
    # rollout (H), ONE launch for the linearization's primal (all
    # H (nx + nu) directions in one batch), and the line search (H, its
    # step sizes batched)
    per_plan = CEM_ITERS * H_PLAN + H_PLAN + ILQR_ITERS * (H_PLAN + 1 + H_PLAN)
    ps = planner.init(seed=0)
    kern = env.kernel
    kern.launches = 0
    counts, infos, walls = [], [], []
    for _ in range(1 + TIMED_PLANS):
        before = kern.launches
        t0 = time.perf_counter()
        ps, action, info = planner.plan_step(ps, env._state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(kern.launches - before)
        infos.append({k: float(v) for k, v in info.items()})
    launches = kern.launches
    passes = {n: len(spans[n]) // (1 + TIMED_PLANS) for n in ("rollout", "linearize", "line_search")}
    for i, (n, info, wall) in enumerate(zip(counts, infos, walls)):
        split = ", ".join(f"{sum(spans[k][i * c:(i + 1) * c]):.3f} s in {c} {k}"
                          for k, c in passes.items())
        print(f"[stack] plan step {i}{' (warm-up)' if i == 0 else ''}: {wall:.3f} s (CEM "
              f"{spans['cem'][i]:.3f} s, iLQR {spans['ilqr'][i]:.3f} s: {split}), kernel launches {n}, "
              f"CEM best return {info['cem_best_return']:.4f}, iLQR cost "
              f"{info['ilqr_initial_cost']:.4f} -> {info['ilqr_final_cost']:.4f}", flush=True)
        if n != per_plan:
            fail(f"plan step {i} launched the kernel {n} times, not {per_plan}")
        if not (all(map(lambda v: v == v and abs(v) != float("inf"), info.values()))
                and info["ilqr_final_cost"] <= info["ilqr_initial_cost"]):
            fail(f"plan step {i}: non-finite costs or iLQR ended above its start: {info}")
    if not bool(torch.isfinite(ps.mean).all()) or not bool(torch.isfinite(action).all()):
        fail("CEM + iLQR gave a non-finite plan")
    obs, reward, *_ = env.step(action)
    if obs.shape != (1, 48) or not bool(torch.isfinite(obs).all()) or not bool(
            torch.isfinite(reward).all()):
        fail(f"StackCube env step after planning gave obs {tuple(obs.shape)}")
    cem_s = statistics.mean(spans["cem"][1:])
    ilqr_s = statistics.mean(spans["ilqr"][1:])
    wall_s = statistics.mean(walls[1:])
    print(f"[stack] StackCube-v1 CEM+iLQR (CEM H={H_PLAN} K={K_CEM} E={ELITES} x{CEM_ITERS}, "
          f"iLQR H={H_PLAN} x{ILQR_ITERS}): {wall_s:.3f} s per plan step (CEM {cem_s:.3f} s, "
          f"iLQR {ilqr_s:.3f} s), CEM {K_CEM * CEM_ITERS / cem_s:.1f} rollouts/s, "
          f"{per_plan} kernel launches per plan step ({launches} in {1 + TIMED_PLANS}), "
          f"step reward {float(reward[0]):.4f}", flush=True)
    return launches


def solve_phase(linalg, solve_kernel):
    """Phase 7: K1 against its plain version at the CUDA test's shapes, SPD
    and non-PD, the strict upper triangle NaN; times at n = 9, 15, 21, 27
    and K = 4096, 16384, 65536; its entry point driven once. Returns the
    ``kernels`` line's numbers for n = 21 at K = 4096 and at K = 65536."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms, queued_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def systems(K, n):
        X = torch.randn((K, n, n), generator=gen, device="cuda")
        A = X @ X.transpose(1, 2) + n * torch.eye(n, device="cuda")
        return A, torch.randn((K, n), generator=gen, device="cuda")

    def non_pd(K, n):
        """System k % 4: a pivot of -1 in row 0, a zero pivot in the last
        row, a zero pivot in row 0 (each beside the rest of an SPD matrix),
        the diagonal (2, -1, 3, ...): pivots exact in float32."""
        A, b = systems(K, n)
        case = torch.arange(K, device="cuda") % 4
        row = torch.where(case == 1, n - 1, 0)
        keep = torch.arange(n, device="cuda")[None, :] != row[:, None]  # (K, n)
        A = A * (keep[:, :, None] & keep[:, None, :])
        A[torch.arange(K, device="cuda"), row, row] = torch.where(case == 0, -1.0, 0.0)
        diag = torch.diag(torch.tensor([2.0, -1.0, 3.0], device="cuda").repeat(n)[:n])
        return torch.where((case == 3)[:, None, None], diag, A), b

    def nan_upper(A):
        n = A.shape[-1]
        upper = torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1)
        return A.masked_fill(upper, float("nan"))

    max_err = max_rel = 0.0
    for n in (1, 9, 15, 21, 27, 32):
        for K in (4096, 37, 1):
            for case in ("spd", "non_pd"):
                A, b = systems(K, n) if case == "spd" else non_pd(K, n)
                got = solve_kernel.solve_psd(nan_upper(A), b)
                ref = linalg.solve_psd(A, b)
                torch.cuda.synchronize()
                fin = torch.isfinite(ref)
                if not torch.equal(torch.isfinite(got), fin):
                    fail(f"K1 n={n} K={K} {case}: non-finite entries in other places than the "
                         "plain version's")
                err = (got - ref).abs().where(fin, 0.0)
                if case == "spd":
                    max_err = max(max_err, float(err.max()))
                    if float(err.max()) > K1_TOL:
                        fail(f"K1 disagrees with its plain version at n={n}, K={K}: "
                             f"{float(err.max()):.3e}")
                    continue
                # the finite entries within 1e-5 of the system's largest
                # |x|; the diagonal systems entry by entry
                scale = ref.abs().where(fin, 0.0).amax(dim=1, keepdim=True)
                rel = float((err / scale.clamp_min(1e-30)).max())
                diag = err[3::4] / ref[3::4].abs()
                rel = max(rel, float(diag.max()) if diag.numel() else 0.0)
                max_rel = max(max_rel, rel)
                if rel > K1_REL_TOL:
                    fail(f"K1 disagrees with its plain version on non-PD systems at n={n}, "
                         f"K={K}: {rel:.3e} relative")
    print(f"[k1] n in (1, 9, 15, 21, 27, 32), K in (4096, 37, 1), strict upper triangle NaN: "
          f"SPD max |kernel - plain| {max_err:.3e} (tol {K1_TOL:g}); non-PD (a negative or a "
          f"zero pivot) non-finite entries in the plain version's places, finite ones "
          f"{max_rel:.3e} relative (tol {K1_REL_TOL:g})", flush=True)

    def library(A, b):
        L, _info = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    numbers = {}
    for n in (9, 15, 21, 27):
        for K in (4096, 16384, 65536):
            A, b = systems(K, n)
            solve_kernel.launch(A, b)
            k_ms = queued_ms(lambda: solve_kernel.launch(A, b), 50)
            w_ms = queued_ms(lambda: solve_kernel.solve_psd(A, b), 50)
            k_call_ms = event_ms(lambda: solve_kernel.launch(A, b), 50)
            l_ms = event_ms(lambda: library(A, b), 20)  # it waits on the host: timed alone
            lib_err = float((library(A, b) - solve_kernel.launch(A, b)).abs().max())
            p_ms = event_ms(lambda: linalg.solve_psd(A, b), 10) if K == 4096 else None
            nbytes, ops = solve_kernel.work(K, n)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            numbers[n, K] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            print(f"[time] K1 n={n} K={K}: kernel {k_ms:.4f} ms ({bound / k_ms * 100:.1f} % of "
                  f"the bound; {k_call_ms:.4f} ms a launch timed alone, the host's call "
                  f"included), entry point {w_ms:.4f} ms, library (cholesky_ex + "
                  f"cholesky_solve, max |lib - kernel| {lib_err:.1e}) {l_ms:.4f} ms, plain "
                  + (f"{p_ms:.4f} ms" if p_ms is not None else "not timed")
                  + f", bound {bound:.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops:.0f} ops "
                  f"-> {ops_ms:.5f} ms)", flush=True)
            if k_call_ms > l_ms:
                print(f"[time] K1 n={n} K={K}: the kernel, timed alone, is slower than the "
                      "library call", flush=True)
            del A, b
    torch.cuda.empty_cache()
    # its entry point, driven once as a caller would (n = 21: StackCube's
    # n_all), with the count read around it
    A, b = systems(4096, 21)
    solve_kernel.launches = 0
    x = solve_kernel.solve_psd(A, b)
    torch.cuda.synchronize()
    launches = solve_kernel.launches
    if launches != 1 or not bool(torch.isfinite(x).all()):
        fail(f"solve_psd launched K1 {launches} times, not 1, or gave non-finite x")
    out = {}
    for K in (4096, 65536):
        out[K] = dict(launches=launches, max_err=max_err, **numbers[21, K])
    out[65536]["plain_ms"] = numbers[21, 4096]["plain_ms"]
    return out


def _ik_aux(env, state):
    """The FK ``aux`` that ``_advance`` hands a task-space controller."""
    import torch
    from maniskill_tpu_torch.envs.base_env import TaskContext

    ctx = TaskContext(env, state)
    base = torch.as_tensor(env.model.robot_base_pose, device="cuda")
    return base, ctx.body_pos, ctx.body_quat, ctx.axis_w


def time_k2(kern, megakernel, sim, cmd):
    """(kernel ms, plain ms, bytes ms, operations ms) of one control step
    (5 sim steps) of ``sim, cmd`` through K2 and its plain step."""
    from maniskill_tpu_torch._cuda import event_ms

    n_sub = 5 * kern.model.params.substeps
    plane = megakernel.pack(kern.plan, sim, cmd)
    kern.launch(plane, n_sub)
    k_ms = event_ms(lambda: kern.launch(plane, n_sub), 20)
    p_ms = event_ms(lambda: kern.plain(sim, cmd, 5), 5)
    nbytes, ops, _ = megakernel.work(kern.plan, sim, cmd, n_sub)
    return k_ms, p_ms, nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def modes_phase(mtt, megakernel, solve_kernel):
    """[modes]: PickCube-v1 at K_CHECK envs under each of the Panda's eight
    control modes. One control step of the mode's controller (arm actions
    of 0.3 at most in the normalized modes: 0.03 rad of delta, 3 cm and
    0.03 rad of TCP motion, 0.3 rad/s; in the raw ones targets 0.03 rad at
    most from the current arm position, as the delta modes', and raw
    velocity targets of 0.3 rad/s at most: raw targets 0.3 rad off in a
    grasp make both float32 steps leave a float64 step's tolerances in 8 %
    of the contact envs, beyond the referee rule's share;
    the gripper at random on reset states, shut on contact states) from
    reset states (every env held in full) and from ``contact_state``
    states (kernel_phase's contact rule) through K2 against the plain step
    (``compare_step``); then one ``env.step`` through the entry point,
    which must launch K2 once and, under a task-space mode, K1 once. The
    kernels line's numbers: the largest error over the modes, and K2's
    time and bound on the pd_ee_delta_pose contact step."""
    import torch
    from maniskill_tpu_torch.agents.robots.panda import Panda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    out = dict(max_err=0.0, launches=0)
    for mode in Panda(device="cuda").supported_control_modes:
        env = mtt.make("PickCube-v1", num_envs=K_CHECK, reward_mode="dense", control_mode=mode)
        env.reset(seed=0)
        kern, ctrl = env.kernel, env.agent.controller
        arm_raw = not ctrl.controllers["arm"].normalize_action
        st = env._state
        cst = env.contact_state(st, gen)
        actions = {}
        for label, s in (("reset", st), ("contact", cst)):
            a = 0.3 * (2 * torch.rand((K_CHECK, env.action_dim), generator=gen,
                                      device="cuda") - 1)
            if arm_raw:  # targets 0.03 rad at most from qpos, as the delta modes'
                a[:, :7] = s.sim.qpos[:, :7] + 0.1 * a[:, :7]
            if label == "contact":
                a[:, -1] = -1.0
            else:
                a[:, -1] = 2 * torch.rand(K_CHECK, generator=gen, device="cuda") - 1
            actions[label] = a
            aux = _ik_aux(env, s) if ctrl.needs_fk_aux else None
            cmd = ctrl.set_action(s.cmd, s.sim.qpos, a, aux=aux)
            referee = torch.full((K_CHECK,), label == "contact", device="cuda")
            err, _, _ = compare_step(kern, f"PickCube-v1 K={K_CHECK} {mode}", label, s.sim, cmd,
                                     referee)
            out["max_err"] = max(out["max_err"], err)
            if mode == "pd_ee_delta_pose" and label == "contact":
                k_ms, p_ms, bytes_ms, ops_ms = time_k2(kern, megakernel, s.sim, cmd)
                out |= dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        # the entry point: one env step of the reset states, with their action
        a = actions["reset"]
        env._state = st
        kern.launches = solve_kernel.launches = 0
        obs, reward, *_ = env.step(a)
        torch.cuda.synchronize()
        want = (1, 1 if ctrl.needs_fk_aux else 0)
        if (kern.launches, solve_kernel.launches) != want:
            fail(f"[modes] {mode}: env.step launched K2 {kern.launches} and K1 "
                 f"{solve_kernel.launches} times, not {want}")
        if not (torch.isfinite(obs).all() and torch.isfinite(reward).all()):
            fail(f"[modes] {mode}: env.step gave non-finite obs or reward")
        out["launches"] += kern.launches
        print(f"[modes] {mode}: action dim {env.action_dim}; env.step launched K2 "
              f"{kern.launches}, K1 {solve_kernel.launches}", flush=True)
        del env, st, cst
    torch.cuda.empty_cache()
    print(f"[modes] every mode within the tolerances: largest |kernel - plain| "
          f"{out['max_err']:.3e}; K2 on the pd_ee_delta_pose contact step {out['ms']:.4f} "
          f"ms/launch, plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms",
          flush=True)
    return out


def ee_phase(mtt, megakernel, solve_kernel, linalg, planners):
    """[ee]: the task-space modes on PickCube-v1. For pd_ee_delta_pose (n =
    6) and pd_ee_delta_pos (n = 3): the IK systems of the controller on
    K_CHECK reset states (its Jacobians, A = J Jᵀ + λ²I, a random action's
    Δx) through K1 against its plain version within K1_TOL, and the
    controller's targets through K1 against those through the plain
    version within K1_TOL; K1's time on those systems (launches queued
    back to back), its plain version's and the library call's
    (``cholesky_ex`` + ``cholesky_solve``), its bound; one rollout step
    under ``set_sync_debug_mode("error")`` (after one to warm the cached
    tables): the IK path makes no host sync; then MPPI at the bench shape
    (H=50, K=4096, sigma 0.6, temperature 0.3) with the mode's action
    dims, K1 launched once a rollout step. Returns the kernels line's
    numbers of K1 by n, and K2's MPPI path under pd_ee_delta_pose."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms, queued_ms

    def library(A, b):
        L, _info = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    k1, k2 = {}, None
    for mode, n in (("pd_ee_delta_pose", 6), ("pd_ee_delta_pos", 3)):
        env = mtt.make("PickCube-v1", num_envs=K_CHECK, reward_mode="dense", control_mode=mode)
        env.reset(seed=0)
        st, ctrl = env._state, env.agent.controller
        a = 2 * torch.rand((K_CHECK, env.action_dim), generator=gen, device="cuda") - 1
        aux = _ik_aux(env, st)
        systems, k1_solve = [], solve_kernel.solve_psd

        def capture(A, b):
            systems.append((A.contiguous(), b.contiguous()))
            return k1_solve(A, b)

        solve_kernel.solve_psd = capture
        try:
            cmd_k = ctrl.set_action(st.cmd, st.sim.qpos, a, aux=aux)
            solve_kernel.solve_psd = linalg.solve_psd
            cmd_p = ctrl.set_action(st.cmd, st.sim.qpos, a, aux=aux)
        finally:
            solve_kernel.solve_psd = k1_solve
        A, b = systems[0]
        if A.shape != (K_CHECK, n, n):
            fail(f"[ee] {mode}: IK systems of shape {tuple(A.shape)}, not {(K_CHECK, n, n)}")
        x_k, x_p = solve_kernel.launch(A, b), linalg.solve_psd(A, b)
        torch.cuda.synchronize()
        err = float((x_k - x_p).abs().max())
        t_err = float((cmd_k.target_qpos - cmd_p.target_qpos).abs().max())
        lib_err = float((library(A, b) - x_k).abs().max())
        if not (err <= K1_TOL and t_err <= K1_TOL):
            fail(f"[ee] {mode}: K1 against its plain version {err:.3e}, the targets "
                 f"{t_err:.3e} (tol {K1_TOL:g})")
        k_ms = queued_ms(lambda: solve_kernel.launch(A, b), 50)
        p_ms = event_ms(lambda: linalg.solve_psd(A, b), 10)
        l_ms = event_ms(lambda: library(A, b), 20)
        nbytes, ops = solve_kernel.work(K_CHECK, n)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        diag = torch.diagonal(A, dim1=1, dim2=2)
        print(f"[ee] {mode}: K1 on the controller's {K_CHECK} IK systems (n={n}, diagonal "
              f"{float(diag.min()):.4f} to {float(diag.max()):.4f}): max |kernel - plain| "
              f"{err:.3e}, targets {t_err:.3e} (tol {K1_TOL:g}); kernel {k_ms:.4f} ms "
              f"(queued), plain {p_ms:.4f} ms, library {l_ms:.4f} ms (max |lib - kernel| "
              f"{lib_err:.1e}), bound {max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> "
              f"{bytes_ms:.5f} ms, {ops:.0f} ops -> {ops_ms:.5f} ms)", flush=True)
        # no host sync on the IK path: one rollout step under the sync check
        env._rollout_step(st, a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st2, reward, _ = env._rollout_step(st, a)
        except RuntimeError as e:
            torch.cuda.set_sync_debug_mode(0)
            fail(f"[ee] {mode}: the rollout step synchronized the host: {e}")
        torch.cuda.set_sync_debug_mode(0)
        if not (torch.isfinite(st2.sim.qpos).all() and torch.isfinite(reward).all()):
            fail(f"[ee] {mode}: the rollout step gave non-finite state or reward")
        print(f"[ee] {mode}: one rollout step of {K_CHECK} envs under "
              f"set_sync_debug_mode('error'): no host sync", flush=True)
        del env, st, st2, A, b, systems
        torch.cuda.empty_cache()
        path = mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "PickCube-v1", 42,
                          control_mode=mode, bound_every=25, profile=n == 6)
        print(f"[ee] PickCube-v1 {mode} MPPI at the bench shape: {path['rps']:.1f} rollouts/s, K2 "
              f"{path['path_ms']:.4f} ms a launch, K1 (n={n}) {path['k1_path_ms']:.4f} ms a "
              f"launch, {path['k1_launches'] // (TIMED_SOLVES + 1)} K1 launches a solve",
              flush=True)
        k1[n] = dict(launches=path["k1_launches"], max_err=err, ms=k_ms, plain_ms=p_ms,
                     library_ms=l_ms, bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     path_ms=path["k1_path_ms"])
        if n == 6:
            k2 = path
    return k1, k2


def solutions_phase(mtt, megakernel, solve_kernel):
    """[solutions]: PullCubeTool-v1's K2 against the plain step on K_CHECK
    reset states (every env held in full), its time, bound and slice; then
    every ported scripted solution at K_SOL envs on K2 (seed 0, no reset
    noise): the success rate, env steps/s (control steps x envs over the
    synchronized wall), K2 and K1 launched once a control step, the final
    states finite; then PickCube-v1 and FoldSuitcase-v1 at K_SOL_AB envs on
    K2 and on the plain step (``sim_backend="torch"``), the same seed: the
    success rates may differ by 3 binomial standard errors of the
    difference plus 0.02. Returns the kernels line's numbers."""
    import math

    import torch
    from maniskill_tpu_torch.examples.motionplanning.solutions import CONTROL_MODES, SOLUTIONS

    env = mtt.make("PullCubeTool-v1", num_envs=K_CHECK, reward_mode="dense",
                   control_mode="pd_ee_delta_pos")
    env.reset(seed=0)
    st, kern = env._state, env.kernel
    cmd = st.cmd.replace(target_qpos=st.cmd.target_qpos + 0.05 * torch.randn(
        st.cmd.target_qpos.shape, generator=torch.Generator(device="cuda").manual_seed(6),
        device="cuda"))
    task = f"PullCubeTool-v1 K={K_CHECK}"
    err, _, _ = compare_step(kern, task, "reset", st.sim, cmd,
                             torch.zeros(K_CHECK, dtype=torch.bool, device="cuda"))
    out = dict(max_err=err) | occupancy_line(kern, task)
    k_ms, p_ms, bytes_ms, ops_ms = time_k2(kern, megakernel, st.sim, cmd)
    out |= dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"[time] {task} reset: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.5f} ms (bytes {bytes_ms:.5f}, operations {ops_ms:.5f})",
          flush=True)
    del env, st, cmd
    torch.cuda.empty_cache()

    def run(task, k, backend="auto"):
        env = mtt.make(task, num_envs=k, control_mode=CONTROL_MODES.get(task, "pd_ee_delta_pos"),
                       robot_init_qpos_noise=0.0, sim_backend=backend)
        env.reset(seed=0)
        if env.kernel is not None:
            env.kernel.launches = 0
        solve_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        success = SOLUTIONS[task](env)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sim = env._state.sim
        steps = int(env._state.elapsed_steps[0])
        k2 = env.kernel.launches if env.kernel is not None else 0
        if backend == "auto" and (k2, solve_kernel.launches) != (steps, steps):
            fail(f"[solutions] {task}: K2 launched {k2} and K1 {solve_kernel.launches} times "
                 f"in {steps} control steps")
        if not all(bool(torch.isfinite(x).all())
                   for x in (sim.qpos, sim.qvel, sim.free_pose, sim.free_vel)):
            fail(f"[solutions] {task}: final states not finite")
        rate = float(success.mean())
        print(f"[solutions] {task} B={k} {'K2' if backend == 'auto' else 'plain step'}: "
              f"success {rate:.4f} ({int(success.sum())}/{k}), {steps} control steps in "
              f"{dt:.1f} s, {steps * k / dt:.1f} env steps/s; K2 launches {k2}, K1 "
              f"{solve_kernel.launches}", flush=True)
        return rate, k2

    out["launches"] = 0
    rates = {}
    for task in SOLUTIONS:
        rates[task], k2 = run(task, K_SOL)
        out["launches"] += k2
        torch.cuda.empty_cache()
    for task in ("PickCube-v1", "FoldSuitcase-v1"):
        p_k, _ = run(task, K_SOL_AB)
        p_p, _ = run(task, K_SOL_AB, backend="torch")
        se = math.sqrt((p_k * (1 - p_k) + p_p * (1 - p_p)) / K_SOL_AB)
        print(f"[solutions] {task} B={K_SOL_AB}: K2 {p_k:.4f} against the plain step "
              f"{p_p:.4f} (allowed {3 * se + 0.02:.4f})", flush=True)
        if abs(p_k - p_p) > 3 * se + 0.02:
            fail(f"[solutions] {task}: success on K2 {p_k:.4f}, on the plain step {p_p:.4f}")
    out["success"] = rates
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import maniskill_tpu_torch as mtt
        from maniskill_tpu_torch import _cuda, planners
        from maniskill_tpu_torch.physics import engine, linalg, megakernel, solve_kernel
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build: one nvcc per source, all at once ----
    t_start = t0 = time.perf_counter()
    laps = [t0]

    def lap(phase):
        """Print the seconds since the last lap: the phase before ``phase``."""
        now = time.perf_counter()
        print(f"[lap] up to phase {phase}: {now - laps[-1]:.1f} s", flush=True)
        laps.append(now)

    libs = _cuda.build("megakernel", "solve_psd")
    print(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():  # K1 has a kernel for each n: identical lines counted once
            lines = [line.strip() for line in log.read_text().splitlines()
                     if any(w in line for w in ("registers", "spill", "stack frame", "smem"))]
            for line in dict.fromkeys(lines):
                count = lines.count(line)
                print(f"[build] {lib.name.split('_')[0]}: {line}"
                      + (f" (x{count})" if count > 1 else ""))
    caps = megakernel._caps()
    print(f"[build] megakernel: {caps['WARPS']} envs (warps) a block, each env's slice of "
          "shared memory sized per scene at launch (dynamic; [time] lines)", flush=True)

    lap("2")
    # ---- 2. K2 against its plain version on each path's scene ----
    pick = kernel_phase(mtt, engine, megakernel, "PickCube-v1", pickcube_branches)
    pick["ragged_max_abs_err"] = ragged_phase(mtt)
    stack = kernel_phase(mtt, engine, megakernel, "StackCube-v1", stackcube_branches)
    # a hull whose lowest point sits above its AABB half height (the reset
    # height) drops onto the table: up to 3 cm down. PickSingleYCB-v1 at
    # K=8192 is the plane its MPPI path launches; PickSingleHull-v1 at
    # K=4096 is an extra check of the same branches
    ycb = kernel_phase(mtt, engine, megakernel, "PickSingleYCB-v1", hull_branches, k=K_YCB,
                       settle_band=(-0.03, 0.005))
    torch.cuda.empty_cache()
    kernel_phase(mtt, engine, megakernel, "PickSingleHull-v1", hull_branches,
                 settle_band=(-0.03, 0.005))
    torch.cuda.empty_cache()
    # spheres and capsules: PlugCharger (20 substeps a launch; the charger
    # starts on the table) and RollBall (the ball starts on the table)
    plug = kernel_phase(mtt, engine, megakernel, "PlugCharger-v1", plug_branches,
                        contact_cmd="own")
    roll = kernel_phase(mtt, engine, megakernel, "RollBall-v1", roll_branches, contact_cmd="own")
    torch.cuda.empty_cache()
    # the rest of the BASELINE MPC set: PushCube (its cube held as
    # PickCube's), PokeCube (two free bodies: peg-cube box_box) and
    # PegInsertionSide (a peg sized per env through geom_size, in a hole of
    # four kinematic walls); the held pegs under their own command
    push = kernel_phase(mtt, engine, megakernel, "PushCube-v1", pickcube_branches)
    poke = kernel_phase(mtt, engine, megakernel, "PokeCube-v1", poke_branches, contact_cmd="own")
    peg = kernel_phase(mtt, engine, megakernel, "PegInsertionSide-v1", peg_branches,
                       contact_cmd="own")
    torch.cuda.empty_cache()
    # hulls against capsules: the Allegro hand holding a hull per env
    # (capsule_hull, plane_capsule; nq 16); spheres and hulls against
    # hulls: the hull stack (sphere_hull, hull_hull)
    inhand = kernel_phase(mtt, engine, megakernel, "RotateSingleObjectInHandLevel2-v1",
                          inhand_branches, contact_cmd="own", inhand=True)
    inhand |= stack_phase(megakernel)
    torch.cuda.empty_cache()
    # robot-only forests (F=0): an articulated object's tree beside the
    # robot's, points with a robot link on each side
    fold = kernel_phase(mtt, engine, megakernel, "FoldSuitcaseModels-v1", art_branches,
                        contact_cmd="own", limit_gate=True)
    faucet = kernel_phase(mtt, engine, megakernel, "TurnFaucet-v1", art_branches,
                          contact_cmd="own")
    cabinet = kernel_phase(mtt, engine, megakernel, "OpenCabinetDrawer-v1", art_branches,
                           contact_cmd="own")
    torch.cuda.empty_cache()
    # the control suite: torque actuation (qf), the robot's own links under
    # gravity, a root of slide and hinge chains; the humanoid (nq 27) and
    # the hopper on the floor, and Cartpole (P = 0: no points at all)
    humanoid = control_phase(mtt, engine, megakernel, "MS-HumanoidStand-v1")
    hopper = control_phase(mtt, engine, megakernel, "MS-HopperStand-v1")
    cartpole = control_phase(mtt, engine, megakernel, "MS-CartpoleBalance-v1")
    torch.cuda.empty_cache()

    lap("3")
    # ---- 3. the differentiable step on the card ----
    seam_err = seam_phase(mtt, planners.ILQR, planners.ILQRConfig)
    print(f"[seam] largest relative difference {seam_err:.3e}", flush=True)

    lap("4")
    # ---- 4. the PickCube main path: MPPI ----
    pick |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "PickCube-v1", 42)

    lap("5")
    # ---- 5. the PickSingleYCB path: MPPI at config #5 ----
    torch.cuda.empty_cache()
    ycb |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "PickSingleYCB-v1",
                      46, num_samples=K_YCB, sigma=SIGMA_YCB, temperature=TEMP_YCB)

    lap("5b")
    # ---- 5b. the PlugCharger and RollBall paths: MPPI at the bench shape ----
    torch.cuda.empty_cache()
    plug |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "PlugCharger-v1", 39)
    roll |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "RollBall-v1", 44,
                       profile=False)

    lap("5c")
    # ---- 5c. the in-hand path: RotateSingleObjectInHandLevel2-v1 MPPI ----
    torch.cuda.empty_cache()
    inhand |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig,
                         "RotateSingleObjectInHandLevel2-v1", 40, profile=False)

    lap("5d")
    # ---- 5d. the articulated paths: MPPI at the JAX package's configs ----
    for numbers, task, obs_dim in ((fold, "FoldSuitcase-v1", 34), (faucet, "TurnFaucet-v1", 32),
                                   (cabinet, "OpenCabinetDrawer-v1", 46)):
        torch.cuda.empty_cache()
        numbers |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, task, obs_dim,
                              profile=False)

    lap("5e")
    # ---- 5e. the control-suite paths: MPPI at the bench shape ----
    # a humanoid rollout that falls flat reaches its root chain's
    # singularity (control_phase) and may end non-finite, as in the JAX
    # package, whose MPPI masks such returns the same way; MPPI gives them
    # zero weight, and half must stay finite
    torch.cuda.empty_cache()
    humanoid |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig,
                           "MS-HumanoidStand-v1", 54, min_finite=0.5)
    cartpole |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig,
                           "MS-CartpoleBalance-v1", 10, profile=False)
    hopper |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig,
                         "MS-HopperStand-v1", 14, profile=False)

    lap("5f")
    # ---- 5f. the rest of the BASELINE MPC set: PegInsertionSide MPPI at
    # config #4 (H=80, K=16384), PokeCube MPPI at its planner config, and
    # PushCube episodes: the device loop (one CUDA graph a control step)
    # against the host loop ----
    torch.cuda.empty_cache()
    # the bound from every 40th launch of the warm-up solve (rollout steps
    # 0 and 40; every 20th until PR 11): megakernel.work at K=16384 takes
    # seconds a launch
    peg |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig,
                      "PegInsertionSide-v1", 43, bound_every=40)
    torch.cuda.empty_cache()
    poke |= mppi_phase(mtt, megakernel, planners.MPPI, planners.MPPIConfig, "PokeCube-v1", 42)
    push |= episode_phase(mtt, planners)

    lap("6")
    # ---- 6. the StackCube path: CEM + iLQR ----
    stack["launches"] = cem_ilqr_phase(mtt, planners)

    lap("7")
    # ---- 7. K1 ----
    k1 = solve_phase(linalg, solve_kernel)

    lap("8")
    # ---- 8. the Panda's control modes, the task-space (IK) path and the
    # scripted solutions ----
    torch.cuda.empty_cache()
    modes = modes_phase(mtt, megakernel, solve_kernel)
    lap("8 [ee]")
    k1_ee, ee_k2 = ee_phase(mtt, megakernel, solve_kernel, linalg, planners)
    modes |= {k: ee_k2[k] for k in ("path_ms", "path_bound_ms")}
    torch.cuda.empty_cache()
    lap("8 [solutions]")
    sols = solutions_phase(mtt, megakernel, solve_kernel)
    lap("done")
    print(f"[done] every phase passed, {time.perf_counter() - t_start:.1f} s with the builds",
          flush=True)

    def entry(name, source, replaces, numbers, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": numbers["launches"], "max_abs_err": numbers["max_err"],
                "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
                "library_ms": library_ms} | {
                    k: numbers[k] for k in ("path_ms", "path_bound_ms", "stack_max_abs_err",
                                            "stack_ms", "stack_plain_ms", "stack_bound_ms",
                                            "slice_bytes", "envs_per_sm",
                                            "stack_slice_bytes", "stack_envs_per_sm",
                                            "ragged_max_abs_err", "limit_band_share",
                                            "max_err_held", "episode_first_action_err",
                                            "episode_replan_hz", "host_replan_hz",
                                            "graph_nodes", "capture_s", "graph_launches",
                                            "graph_k2_ms_each", "graph_busy_ms_per_replay")
                    if k in numbers}

    # K2's ms, max_abs_err and bound_ms: phase 2's contact states at the
    # path's K; path_ms and path_bound_ms: the MPPI path's own launches
    k2_src, k2_tpu = "maniskill_tpu_torch/csrc/megakernel.cu", "maniskill_tpu/physics/megakernel.py:494"
    k1_src, k1_tpu = "maniskill_tpu_torch/csrc/solve_psd.cu", "maniskill_tpu/physics/pallas_kernels.py:27"
    print(json.dumps({"kernels": [
        entry("megakernel_step", k2_src, k2_tpu, pick) | {"inputs": f"PickCube-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, stack)
        | {"inputs": f"StackCube-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, ycb) | {"inputs": f"PickSingleYCB-v1, K={K_YCB}"},
        entry("megakernel_step", k2_src, k2_tpu, plug) | {"inputs": f"PlugCharger-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, roll) | {"inputs": f"RollBall-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, push)
        | {"inputs": f"PushCube-v1, K={K_CHECK}; launches: the device episode's K2 wrapper "
                     f"calls (warm-up and capture), H=20, K=2048; graph_launches: the graph's "
                     f"K2 kernel nodes times its {EPISODE_STEPS} replays; graph_*_ms: a "
                     f"profile of {PROFILED_STEPS} replays of a second episode"},
        entry("megakernel_step", k2_src, k2_tpu, poke) | {"inputs": f"PokeCube-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, peg)
        | {"inputs": f"PegInsertionSide-v1, K={K_CHECK}; path_*: MPPI H=80, K=16384"},
        entry("megakernel_step", k2_src, k2_tpu, inhand)
        | {"inputs": f"RotateSingleObjectInHandLevel2-v1, K={K_CHECK}; stack_*: the hull stack "
                     f"(sphere_hull, hull_hull), K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, fold)
        | {"inputs": f"FoldSuitcaseModels-v1, K={K_CHECK}; path_*: FoldSuitcase-v1 MPPI"},
        entry("megakernel_step", k2_src, k2_tpu, faucet) | {"inputs": f"TurnFaucet-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, cabinet)
        | {"inputs": f"OpenCabinetDrawer-v1, K={K_CHECK}"},
        entry("megakernel_step", k2_src, k2_tpu, humanoid)
        | {"inputs": f"MS-HumanoidStand-v1, K={K_CHECK}, contact states"},
        entry("megakernel_step", k2_src, k2_tpu, hopper)
        | {"inputs": f"MS-HopperStand-v1, K={K_CHECK}, contact states"},
        entry("megakernel_step", k2_src, k2_tpu, cartpole)
        | {"inputs": f"MS-CartpoleBalance-v1, K={K_CHECK}, settled states (P=0)"},
        entry("solve_psd", k1_src, k1_tpu, k1[4096], k1[4096]["library_ms"])
        | {"inputs": "n=21, K=4096, SPD"},
        entry("solve_psd", k1_src, k1_tpu, k1[65536], k1[65536]["library_ms"])
        | {"inputs": "n=21, K=65536, SPD; plain_ms at K=4096"},
        entry("megakernel_step", k2_src, k2_tpu, modes)
        | {"inputs": f"PickCube-v1, K={K_CHECK}, the Panda's eight control modes (max_abs_err "
                     f"over them; ms, plain_ms, bound_ms: the pd_ee_delta_pose contact step); "
                     f"launches: one env.step a mode; path_*: MPPI H=50, K=4096 under "
                     f"pd_ee_delta_pose"},
        entry("megakernel_step", k2_src, k2_tpu, sols)
        | {"inputs": f"PullCubeTool-v1, K={K_CHECK}, reset states; launches: every scripted "
                     f"solution at B={K_SOL}, one a control step"},
        entry("solve_psd", k1_src, k1_tpu, k1_ee[6], k1_ee[6]["library_ms"])
        | {"inputs": f"n=6, K={K_CHECK}: the pd_ee_delta_pose IK systems of PickCube-v1 reset "
                     f"states; launches: MPPI H=50, K=4096, {TIMED_SOLVES + 1} solves; path_ms: "
                     f"a launch in those solves"},
        entry("solve_psd", k1_src, k1_tpu, k1_ee[3], k1_ee[3]["library_ms"])
        | {"inputs": f"n=3, K={K_CHECK}: the pd_ee_delta_pos IK systems of PickCube-v1 reset "
                     f"states; launches: MPPI H=50, K=4096, {TIMED_SOLVES + 1} solves; path_ms: "
                     f"a launch in those solves"},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
