#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or ends the script with a non-zero exit):
  1. build the CUDA mega-kernel from the sources in this checkout;
  2. hold the kernel against its plain PyTorch version on the card: one
     control step (5 substeps) of K=4096 PickCube-v1 states with perturbed
     drive targets, aux outputs included, from reset states and from states
     in contact (``PickCubeEnv.contact_state``; the check fails unless every
     pair function and friction carry force there), then a 10-control-step
     settle check through the kernel alone; time the kernel and its plain
     version and count the step's work for the bound;
  3. drive the port's main path: ``make("PickCube-v1")``, ``reset``, then
     MPPI at H=50, K=4096 (sigma 0.6, temperature 0.3): one warm-up solve and
     5 timed solves, with the kernel's launch count read around them;
  4. print one JSON line of the kernels launched (time per launch, bound,
     plain version's time), the card's name and power limit, and last the
     contract line ``{"ok": true, "device": {...}}``.
Needs one CUDA device; exits non-zero without one or outside the repo.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

H, K_MPPI, K_CHECK = 50, 4096, 4096
TIMED_SOLVES = 5
# kernel vs plain tolerances (tests/test_torch_pickcube.py, from
# tests/test_megakernel.py:48-67): float32 on both sides, sums in another
# order; contact impulses are newtons under a stiff implicit law
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
AUX_TOL = dict(body_pos=2e-5, body_quat=2e-5, axis_w=2e-5, f_pt=5e-3)
CONTACT_SHARE = 0.05  # share of contact-state envs that may leave the tolerances
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


def cuda_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
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


def profile_solve(planner, ps, state):
    """Where one solve's device time goes (torch.profiler over one solve):
    device busy share of the wall time and the top kernels by device time.
    Runs after the launch count is read; prints "not measured" when the
    profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        planner.solve(ps, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): operator rows repeat the
    # device time of the kernels they launch
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and e.self_device_time_total > 0]
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import maniskill_tpu_torch as mtt
        from maniskill_tpu_torch.physics import engine, megakernel
        from maniskill_tpu_torch.planners.mppi import MPPI, MPPIConfig
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib = megakernel.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # ---- 2. kernel against its plain version, K=4096 ----
    env = mtt.make("PickCube-v1", num_envs=K_CHECK, reward_mode="dense")
    env.reset(seed=0)
    kern, plan = env.kernel, env.kernel.plan
    st = env._state
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def perturbed(cmd):
        return cmd.replace(target_qpos=cmd.target_qpos + 0.05 * torch.randn(
            cmd.target_qpos.shape, generator=gen, device="cuda"))

    def outputs(state, aux):
        return {n: getattr(state, n) for n in TOL} | {n: aux[n] for n in AUX_TOL}

    def env_err(a, b):
        """Largest |a - b| of each env, in float64."""
        return (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(1)

    def compare(label, sim, cmd, referee=False):
        """One control step through the kernel and the plain step. With
        ``referee`` the envs may disagree in a few ill-conditioned envs (see
        the contact states below); without, every env must agree."""
        got = outputs(*kern(sim, cmd, 5))
        ref = outputs(*kern.plain(sim, cmd, 5))
        if referee:
            prev = torch.get_default_dtype()
            torch.set_default_dtype(torch.float64)
            try:
                f64 = outputs(*kern.plain(as64(sim), as64(cmd), 5))
            finally:
                torch.set_default_dtype(prev)
        torch.cuda.synchronize()
        max_err, worst = 0.0, []
        for name, tol in (TOL | AUX_TOL).items():
            if not torch.isfinite(got[name]).all():
                fail(f"{label}: kernel output {name} is not finite")
            e = env_err(got[name], ref[name])
            err, n_out = float(e.max()), int((e > tol).sum())
            max_err = max(max_err, err)
            line = (f"[check] {label} {name}: max |kernel - plain| = {err:.3e} (tol {tol:g}, "
                    f"max |plain| {float(ref[name].abs().max()):.3e}), median env "
                    f"{float(e.median()):.3e}, envs beyond tol {n_out}")
            if not referee:
                if n_out:
                    worst.append(f"{name} {err:.3e} > {tol:g}")
            else:
                k64 = int((env_err(got[name], f64[name]) > tol).sum())
                p64 = int((env_err(ref[name], f64[name]) > tol).sum())
                line += f"; beyond tol of the float64 step: kernel {k64}, plain {p64}"
                if n_out > CONTACT_SHARE * e.numel() or k64 > 1.5 * p64 + 8:
                    worst.append(f"{name}: {n_out} envs beyond tol of the plain step, "
                                 f"{k64} (plain: {p64}) beyond tol of the float64 step")
            print(line)
        if worst:
            fail(f"{label}: kernel disagrees with the plain step: " + "; ".join(worst))
        return max_err, ref

    # a) reset states: the cube rests on the table, the hand is far from it
    cmd = perturbed(st.cmd)
    err_reset, _ = compare("reset", st.sim, cmd)
    # b) states in contact (cube in the fingers, fingertips at the table,
    # every fourth cube on the floor): every pair function carries force.
    # Stiff contacts amplify float32 rounding, and a force law with
    # thresholds (margin, load gate, friction cone) flips in a few envs, so
    # the plain float32 step itself leaves the tolerances against a float64
    # step there; the kernel must agree with the plain step in all but
    # CONTACT_SHARE of the envs, and be no further from the float64 step
    # than the plain step is (1.5 x its count of envs beyond tol, plus 8)
    cst = env.contact_state(st, gen)
    ccmd = perturbed(cst.cmd)
    err_contact, cref = compare("contact", cst.sim, ccmd, referee=True)
    loaded = cref["f_pt"].abs().sum(-1) > 0  # (K, P)
    pfn = torch.as_tensor(plan.pfn, device="cuda")
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device="cuda")
    grasp = torch.arange(K_CHECK, device="cuda") % 4 != 3
    depth = engine.compute_contacts(
        env.model, cst.sim, *engine.robot_fk(env.model, cst.sim.qpos)[:2])[2]
    lam_t = cref["contact_lam_t"].abs().sum(-1) > 0
    need = {  # branch: whether it holds in each env it should
        "finger-cube box_box_corners loaded": loaded[grasp][:, pfn == 2].sum(1) >= 4,
        "cube-table box_box_onesided loaded": loaded[grasp][:, (pfn == 1) & ~robot].sum(1) >= 1,
        "fingertip-table box_box_onesided active":
            (depth[grasp][:, (pfn == 1) & robot] > -env.model.params.contact_margin).sum(1) >= 4,
        "cube-floor plane_box loaded": loaded[~grasp][:, pfn == 0].sum(1) >= 1,
        "friction lam_t nonzero": lam_t[grasp].sum(1) >= 6,
    }
    print(f"[check] contact: {int(loaded.sum())} loaded points of {loaded.numel()} "
          f"({float(loaded.sum(1).float().mean()):.2f} per env)")
    for label, holds in need.items():
        share = float(holds.float().mean())
        print(f"[check] contact: {label} in {100 * share:.1f} % of its envs")
        if share < 0.5:
            fail(f"contact states do not exercise {label} (only {100 * share:.1f} %)")
    max_err = max(err_reset, err_contact)

    sim = st.sim
    for _ in range(10):
        sim, _aux = kern(sim, st.cmd, 5)
    z = sim.free_pose[:, 0, 2]
    if not (torch.isfinite(sim.qpos).all() and torch.isfinite(sim.free_pose).all()):
        fail("settle run produced non-finite state")
    if not bool(((z > 0.015) & (z < 0.025)).all()):
        fail(f"cube did not settle: z in [{float(z.min()):.4f}, {float(z.max()):.4f}]")
    print(f"[check] settle: cube z in [{float(z.min()):.5f}, {float(z.max()):.5f}]")

    # kernel time per launch (5 substeps), its bound and the plain step's
    # time at K=4096, on both input sets; the kernels line reports the
    # contact states
    timing = {}
    for label, (s_in, c_in) in dict(reset=(st.sim, cmd), contact=(cst.sim, ccmd)).items():
        plane = megakernel.pack(plan, s_in, c_in)
        kern.launch(plane, 5)
        k_ms = cuda_ms(lambda: kern.launch(plane, 5), 20)
        p_ms = cuda_ms(lambda: kern.plain(s_in, c_in, 5), 5)
        nbytes, ops, counts = megakernel.work(plan, s_in, c_in, 5)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        timing[label] = (k_ms, p_ms, bytes_ms, ops_ms)
        print(f"[time] {label}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops} ops "
              f"-> {ops_ms:.5f} ms; points {counts})", flush=True)
    kernel_ms, plain_ms, bytes_ms, ops_ms = timing["contact"]
    bound_ms = max(bytes_ms, ops_ms)
    del env, st, cst, cref, sim, plane

    # ---- 3. the main path: MPPI on PickCube-v1 ----
    env1 = mtt.make("PickCube-v1", num_envs=1, robot_init_qpos_noise=0.0,
                    reward_mode="dense")
    env1.reset(seed=0)
    planner = MPPI(env1, MPPIConfig(horizon=H, num_samples=K_MPPI, sigma=0.6,
                                    temperature=0.3))
    ps = planner.init(seed=0)
    env1.kernel.launches = 0
    torch.cuda.synchronize()
    ps, info = planner.solve(ps, env1._state)
    torch.cuda.synchronize()
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

    env1.kernel.launch = timed_launch
    t0 = time.perf_counter()
    for _ in range(TIMED_SOLVES):
        ps, info = planner.solve(ps, env1._state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del env1.kernel.launch
    kernel_busy_ms = sum(a.elapsed_time(b) for a, b in spans)
    launches = env1.kernel.launches
    if launches != H * (TIMED_SOLVES + 1):
        fail(f"main path launched the kernel {launches} times, not {H * (TIMED_SOLVES + 1)}")
    returns = info["returns"]
    if returns.shape != (K_MPPI,) or not bool(torch.isfinite(returns).all()):
        fail("MPPI returns are not all finite")
    if not bool(torch.isfinite(ps.nominal).all()):
        fail("MPPI nominal is not finite")
    obs, reward, *_ = env1.step(ps.nominal[0])
    if obs.shape != (1, 42) or not bool(torch.isfinite(obs).all()):
        fail(f"env step after planning gave obs {tuple(obs.shape)}")
    rps = K_MPPI * TIMED_SOLVES / dt
    print(f"[main] PickCube-v1 MPPI H={H} K={K_MPPI}: {rps:.1f} rollouts/s "
          f"({dt / TIMED_SOLVES:.3f} s/solve), best return {float(info['best_return']):.4f}, "
          f"kernel launches {launches}", flush=True)
    print(f"[main] kernel device time {kernel_busy_ms / TIMED_SOLVES:.3f} ms/solve "
          f"({len(spans)} launches timed by CUDA events), "
          f"{100 * kernel_busy_ms / (dt * 1e3):.1f} % of the wall time", flush=True)
    profile_solve(planner, ps, env1._state)

    print(json.dumps({"kernels": [{
        "name": "megakernel_step",
        "route": "cuda",
        "source": "maniskill_tpu_torch/csrc/megakernel.cu",
        "replaces": "maniskill_tpu/physics/megakernel.py:494",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
