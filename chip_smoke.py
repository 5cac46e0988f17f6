#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or ends the script with a non-zero exit):
  1. build both CUDA libraries from the sources in this checkout, one
     ``nvcc`` per source, all at once: the physics mega-kernel (K2,
     ``csrc/megakernel.cu``) and the batched SPD solve (K1,
     ``csrc/solve_psd.cu``);
  2. hold K2 against its plain PyTorch step on the card, for PickCube-v1
     and for StackCube-v1 (two free cubes: the free-free box_box pair): one
     control step (5 substeps) of K=4096 states with perturbed drive
     targets, aux outputs included, from reset states and from states in
     contact (``contact_state``; the check fails unless every pair function
     and friction carry force there), then a 10-control-step settle check
     through the kernel alone; time the kernel and its plain version and
     count the step's work for the bound;
  3. the differentiable step on the card: the JVP and the VJP of one
     StackCube ``_rollout_step`` through ``KernelStep`` (kernel primal,
     plain-step derivative) against those of the plain step, K=64;
  4. drive the port's PickCube main path: ``make("PickCube-v1")``,
     ``reset``, then MPPI at H=50, K=4096 (sigma 0.6, temperature 0.3): one
     warm-up solve and 5 timed solves, with K2's launch count read around
     them;
  5. drive the StackCube path: ``make("StackCube-v1")``, ``reset``, then
     CEM + iLQR at BASELINE config #3 (CEM H=60, K=1024, 64 elites, 4
     iterations, sigma 0.5; iLQR H=60, 3 iterations): one warm-up and 2
     timed plan steps, split into CEM and iLQR, K2's launches per plan step
     checked against the design, then one env step with the planned action;
  6. hold K1 against its plain version (n = 9, 15, 21; K = 4096 and 37),
     time it beside its plain version and the library call, and drive its
     entry point once;
  7. print one JSON line of the kernels (launches on their paths, time per
     launch, bound, plain version's and library call's time), the card's
     name and power limit, and last the contract line
     ``{"ok": true, "device": {...}}``.
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
# StackCube CEM + iLQR (BASELINE config #3, the JAX package's
# tools/solve_tasks.py:80-84)
H_PLAN, K_CEM, ELITES, CEM_ITERS, ILQR_ITERS = 60, 1024, 64, 4, 3
TIMED_PLANS = 2
K_SEAM = 64
# kernel vs plain tolerances (tests/test_torch_pickcube.py, from
# tests/test_megakernel.py:48-67): float32 on both sides, sums in another
# order; contact impulses are newtons under a stiff implicit law
TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4,
           contact_lam=5e-3, contact_lam_t=5e-3)
AUX_TOL = dict(body_pos=2e-5, body_quat=2e-5, axis_w=2e-5, f_pt=5e-3)
CONTACT_SHARE = 0.05  # share of contact-state envs that may leave the tolerances
# the seam: per env, |kernel-primal derivative - plain derivative| over the
# env's largest plain derivative; the derivatives themselves come from the
# same plain step, but the reward's are taken at the kernel's primal, which
# differs from the plain step's by float32 rounding
SEAM_REL_TOL = 1e-3
K1_TOL = 1e-4  # A = X Xᵀ + n I, float32, n <= 21
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


def pickcube_branches(env, plan, cst, loaded, depth):
    """What must carry force in PickCube contact states, per env that should."""
    import torch

    pfn = torch.as_tensor(plan.pfn, device="cuda")
    robot = torch.as_tensor((plan.pra >= 0) | (plan.prb >= 0), device="cuda")
    grasp = torch.arange(K_CHECK, device="cuda") % 4 != 3
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
    idx = torch.arange(K_CHECK, device="cuda")
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


def kernel_phase(mtt, engine, megakernel, task, branches):
    """Phase 2 for one task: K2 against its plain step, settle, time, bound."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms

    env = mtt.make(task, num_envs=K_CHECK, reward_mode="dense")
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

    def compare(label, sim, cmd, referee):
        """One control step through the kernel and the plain step. Every
        env outside the mask ``referee`` (K,) must agree within the
        tolerances. The envs in it are ill-conditioned (see the contact
        states below): at most CONTACT_SHARE of them may disagree, and the
        kernel must be no further from a float64 plain step there than the
        float32 plain step is."""
        got = outputs(*kern(sim, cmd, 5))
        ref = outputs(*kern.plain(sim, cmd, 5))
        n_ref = int(referee.sum())
        if n_ref:
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
                fail(f"{task} {label}: kernel output {name} is not finite")
            e = env_err(got[name], ref[name])
            beyond = e > tol
            err, n_strict = float(e.max()), int((beyond & ~referee).sum())
            max_err = max(max_err, err)
            line = (f"[check] {task} {label} {name}: max |kernel - plain| = {err:.3e} (tol "
                    f"{tol:g}, max |plain| {float(ref[name].abs().max()):.3e}), median env "
                    f"{float(e.median()):.3e}, envs beyond tol {n_strict} of "
                    f"{K_CHECK - n_ref} held in full")
            if n_strict:
                worst.append(f"{name}: {n_strict} envs held in full beyond tol {tol:g}")
            if n_ref:
                n_out = int((beyond & referee).sum())
                k64 = int(((env_err(got[name], f64[name]) > tol) & referee).sum())
                p64 = int(((env_err(ref[name], f64[name]) > tol) & referee).sum())
                line += (f", {n_out} of {n_ref} refereed; beyond tol of the float64 step: "
                         f"kernel {k64}, plain {p64}")
                if n_out > CONTACT_SHARE * n_ref or k64 > 1.5 * p64 + 8:
                    worst.append(f"{name}: {n_out} refereed envs beyond tol of the plain step, "
                                 f"{k64} (plain: {p64}) beyond tol of the float64 step")
            print(line)
        if worst:
            fail(f"{task} {label}: kernel disagrees with the plain step: " + "; ".join(worst))
        return max_err, ref

    # a) reset states: cubes rest on the table, the hand is far from them;
    # every env must agree. StackCube's placement rule (the JAX package's:
    # centres at least sqrt(2) half + 1 mm apart) lets the two 4 cm cubes
    # start interpenetrating, up to ~2 cm deep, in about a fifth of the
    # envs, and a few of those are as ill-conditioned as the contact states
    # below; only those envs take the contact states' rule
    free_free = torch.as_tensor((plan.pfa >= 0) & (plan.pfb >= 0), device="cuda")
    depth0 = engine.compute_contacts(
        env.model, st.sim, *engine.robot_fk(env.model, st.sim.qpos)[:2])[2]
    overlap = (depth0[:, free_free] > 0).any(1)
    print(f"[check] {task} reset: {int(overlap.sum())} of {K_CHECK} envs start with "
          "free bodies interpenetrating")
    cmd = perturbed(st.cmd)
    err_reset, _ = compare("reset", st.sim, cmd, referee=overlap)
    # b) states in contact: every pair function carries force. Stiff
    # contacts amplify float32 rounding, and a force law with thresholds
    # (margin, load gate, friction cone) flips in a few envs, so the plain
    # float32 step itself leaves the tolerances against a float64 step
    # there; the kernel must agree with the plain step in all but
    # CONTACT_SHARE of the envs, and be no further from the float64 step
    # than the plain step is (1.5 x its count of envs beyond tol, plus 8)
    cst = env.contact_state(st, gen)
    ccmd = perturbed(cst.cmd)
    err_contact, cref = compare("contact", cst.sim, ccmd,
                                referee=torch.ones(K_CHECK, dtype=torch.bool, device="cuda"))
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
    z = sim.free_pose[~overlap][..., 2]
    if not (torch.isfinite(sim.qpos).all() and torch.isfinite(sim.free_pose).all()):
        fail(f"{task} settle run produced non-finite state")
    if not bool(((z > 0.015) & (z < 0.025)).all()):
        fail(f"{task}: cubes did not settle: z in [{float(z.min()):.4f}, {float(z.max()):.4f}]")
    print(f"[check] {task} settle: cube z in [{float(z.min()):.5f}, {float(z.max()):.5f}] "
          f"in the {int((~overlap).sum())} envs whose cubes start apart")

    # kernel time per launch (5 substeps), its bound and the plain step's
    # time at K=4096, on both input sets; the kernels line reports the
    # contact states
    timing = {}
    for label, (s_in, c_in) in dict(reset=(st.sim, cmd), contact=(cst.sim, ccmd)).items():
        plane = megakernel.pack(plan, s_in, c_in)
        kern.launch(plane, 5)
        k_ms = event_ms(lambda: kern.launch(plane, 5), 20)
        p_ms = event_ms(lambda: kern.plain(s_in, c_in, 5), 5)
        nbytes, ops, counts = megakernel.work(plan, s_in, c_in, 5)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        timing[label] = (k_ms, p_ms, bytes_ms, ops_ms)
        print(f"[time] {task} {label}: kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops} ops "
              f"-> {ops_ms:.5f} ms; points {counts})", flush=True)
    k_ms, p_ms, bytes_ms, ops_ms = timing["contact"]
    return dict(max_err=max(err_reset, err_contact), ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


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


def mppi_phase(mtt, MPPI, MPPIConfig):
    """Phase 4: PickCube MPPI, the first slice's main path."""
    import torch

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
    return launches


def cem_ilqr_phase(mtt, planners):
    """Phase 5: StackCube CEM + iLQR at BASELINE config #3."""
    import torch

    env = mtt.make("StackCube-v1", num_envs=1, reward_mode="dense")
    env.reset(seed=0)
    cfg = planners.CEMILQRConfig(
        cem=planners.CEMConfig(horizon=H_PLAN, num_samples=K_CEM, num_elites=ELITES,
                               iterations=CEM_ITERS, init_sigma=0.5),
        ilqr=planners.ILQRConfig(horizon=H_PLAN, iterations=ILQR_ITERS, action_penalty=1e-3))
    planner = planners.CEMILQR(env, cfg)
    # synchronized wall time of each stage, read through wrappers
    spans = {"cem": [], "ilqr": []}
    for name, stage in (("cem", planner.cem), ("ilqr", planner.ilqr)):
        def timed(*a, _solve=stage.solve, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _solve(*a, **kw)
            torch.cuda.synchronize()
            spans[_name].append(time.perf_counter() - t0)
            return out
        stage.solve = timed
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
    for i, (n, info, wall) in enumerate(zip(counts, infos, walls)):
        print(f"[stack] plan step {i}{' (warm-up)' if i == 0 else ''}: {wall:.3f} s (CEM "
              f"{spans['cem'][i]:.3f} s, iLQR {spans['ilqr'][i]:.3f} s), kernel launches {n}, "
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
    """Phase 6: K1 against its plain version; times at K=4096, n=21."""
    import torch
    from maniskill_tpu_torch._cuda import event_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def systems(K, n):
        X = torch.randn((K, n, n), generator=gen, device="cuda")
        A = X @ X.transpose(1, 2) + n * torch.eye(n, device="cuda")
        return A, torch.randn((K, n), generator=gen, device="cuda")

    max_err, timing = 0.0, {}
    for n in (9, 15, 21):
        for K in (4096, 37):
            A, b = systems(K, n)
            got = solve_kernel.solve_psd(A, b)
            ref = linalg.solve_psd(A, b)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"K1 n={n} K={K}: not finite")
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            print(f"[k1] n={n} K={K}: max |kernel - plain| = {err:.3e} (tol {K1_TOL:g}, "
                  f"max |x| {float(ref.abs().max()):.3e})")
            if err > K1_TOL:
                fail(f"K1 disagrees with its plain version at n={n}, K={K}: {err:.3e}")
        A, b = systems(4096, n)
        At, bt = solve_kernel.to_planes(A, b)
        solve_kernel.launch(At, bt)
        k_ms = event_ms(lambda: solve_kernel.launch(At, bt), 50)
        w_ms = event_ms(lambda: solve_kernel.solve_psd(A, b), 50)
        p_ms = event_ms(lambda: linalg.solve_psd(A, b), 10)

        def library():
            L, _info = torch.linalg.cholesky_ex(A)
            return torch.cholesky_solve(b[..., None], L)

        lib_err = float((library()[..., 0] - linalg.solve_psd(A, b)).abs().max())
        l_ms = event_ms(library, 50)
        nbytes, ops = solve_kernel.work(4096, n)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        timing[n] = (k_ms, p_ms, l_ms, bytes_ms, ops_ms)
        print(f"[time] K1 n={n} K=4096: kernel {k_ms:.4f} ms, with the layout transposes "
              f"{w_ms:.4f} ms, plain {p_ms:.4f} ms, library (cholesky_ex + cholesky_solve, "
              f"max |lib - plain| {lib_err:.1e}) {l_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.5f} ms ({nbytes} B -> {bytes_ms:.5f} ms, {ops:.0f} ops "
              f"-> {ops_ms:.5f} ms)", flush=True)
    # its entry point, driven once as a caller would (n = 21: StackCube's
    # n_all), with the count read around it
    A, b = systems(4096, 21)
    solve_kernel.launches = 0
    x = solve_kernel.solve_psd(A, b)
    torch.cuda.synchronize()
    launches = solve_kernel.launches
    if launches != 1 or not bool(torch.isfinite(x).all()):
        fail(f"solve_psd launched K1 {launches} times, not 1, or gave non-finite x")
    k_ms, p_ms, l_ms, bytes_ms, ops_ms = timing[21]
    return dict(launches=launches, max_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=l_ms)


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
    t0 = time.perf_counter()
    libs = _cuda.build("megakernel", "solve_psd")
    print(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "stack frame" in line:
                    print(f"[build] {lib.name.split('_')[0]}: {line.strip()}")

    # ---- 2. K2 against its plain version, K=4096, both scene classes ----
    pick = kernel_phase(mtt, engine, megakernel, "PickCube-v1", pickcube_branches)
    stack = kernel_phase(mtt, engine, megakernel, "StackCube-v1", stackcube_branches)
    torch.cuda.empty_cache()

    # ---- 3. the differentiable step on the card ----
    seam_err = seam_phase(mtt, planners.ILQR, planners.ILQRConfig)
    print(f"[seam] largest relative difference {seam_err:.3e}", flush=True)

    # ---- 4. the PickCube main path: MPPI ----
    pick["launches"] = mppi_phase(mtt, planners.MPPI, planners.MPPIConfig)

    # ---- 5. the StackCube path: CEM + iLQR ----
    stack["launches"] = cem_ilqr_phase(mtt, planners)

    # ---- 6. K1 ----
    k1 = solve_phase(linalg, solve_kernel)

    def entry(name, source, replaces, numbers, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": numbers["launches"], "max_abs_err": numbers["max_err"],
                "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
                "library_ms": library_ms}

    k2_src, k2_tpu = "maniskill_tpu_torch/csrc/megakernel.cu", "maniskill_tpu/physics/megakernel.py:494"
    print(json.dumps({"kernels": [
        entry("megakernel_step", k2_src, k2_tpu, pick) | {"inputs": "PickCube-v1"},
        entry("megakernel_step", k2_src, k2_tpu, stack) | {"inputs": "StackCube-v1"},
        entry("solve_psd", "maniskill_tpu_torch/csrc/solve_psd.cu",
              "maniskill_tpu/physics/pallas_kernels.py:27", k1, k1["library_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
