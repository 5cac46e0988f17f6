"""A/B of the MPPI main path between two checkouts, on one GPU.

    python -m maniskill_tpu_torch.mppi_ab --parent DIR [--task PickCube-v1 ...]
        [--solves 5] [--rounds 1]

Runs the MPPI phase of ``chip_smoke.py`` (each task at its env class's
``MPPI_CONFIG``, read in this checkout: H=50, K=4096, sigma 0.6,
temperature 0.3 unless the task has a planner config of its own; one
warm-up solve, then ``--solves`` timed solves) on the
checkout at ``DIR`` (its root) and on this one, each in a process of its
own, in turns: parent, change, change, parent, ``--rounds`` times. Each
process imports the ``maniskill_tpu_torch`` of its checkout and builds that
checkout's kernel. For each task (repeat the flag for several; default
PickCube-v1) it prints one JSON line per run: rollouts/s and wall ms per
solve; the kernel's device ms per solve (CUDA events around each launch);
the host ms per solve spent in the wrapper's ``pack``, ``launch`` and
``unpack`` (the host's clock, no synchronisation) and the device ms of
``pack`` and ``unpack`` (CUDA events); and, from ``torch.profiler`` over
one more solve, the device busy ms and the count of device ops. Then a
line per task with each checkout's mean.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _worker(root: Path, configs: dict, solves: int) -> None:
    """One checkout's runs: a JSON line per task (``configs``: task ->
    MPPIConfig keyword arguments) on stdout."""
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import maniskill_tpu_torch as mtt
    from maniskill_tpu_torch import planners
    from maniskill_tpu_torch.physics import megakernel

    if Path(mtt.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {mtt.__file__}, not the package under {root}")
    spans = {n: [] for n in ("pack", "launch", "unpack")}
    host = dict.fromkeys(spans, 0.0)

    def timed(name, fn):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = fn(*args)
            b.record()
            host[name] += time.perf_counter() - t0
            spans[name].append((a, b))
            return out
        return run

    for task, cfg in configs.items():
        env = mtt.make(task, num_envs=1, robot_init_qpos_noise=0.0, reward_mode="dense")
        env.reset(seed=0)
        H, K = cfg["horizon"], cfg["num_samples"]
        planner = planners.MPPI(env, planners.MPPIConfig(**cfg))
        ps = planner.init(seed=0)
        ps, _ = planner.solve(ps, env._state)
        torch.cuda.synchronize()
        pack, unpack, launch = megakernel.pack, megakernel.unpack, env.kernel.launch
        megakernel.pack, megakernel.unpack = timed("pack", pack), timed("unpack", unpack)
        env.kernel.launch = timed("launch", launch)
        for v in spans.values():
            v.clear()
        host.update(dict.fromkeys(host, 0.0))
        t0 = time.perf_counter()
        for _ in range(solves):
            ps, _ = planner.solve(ps, env._state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        megakernel.pack, megakernel.unpack = pack, unpack
        del env.kernel.launch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            planner.solve(ps, env._state)
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0]
        dev = {n: sum(a.elapsed_time(b) for a, b in v) / solves for n, v in spans.items()}
        if len(spans["launch"]) != H * solves:
            raise SystemExit(f"{task}: {len(spans['launch'])} launches, not {H * solves}")
        print(json.dumps({
            "task": task, "root": str(root), "rollouts_per_s": K * solves / wall,
            "wall_ms_per_solve": 1e3 * wall / solves, "kernel_ms_per_solve": dev["launch"],
            "pack_ms_per_solve": dev["pack"], "unpack_ms_per_solve": dev["unpack"],
            "host_ms_per_solve": {n: 1e3 * t / solves for n, t in host.items()},
            "profiled_device_busy_ms": sum(r[0] for r in rows) / 1e3,
            "profiled_device_ops": sum(r[1] for r in rows)}), flush=True)
        del env, planner, ps
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--task", action="append")
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--configs", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker.resolve(), json.loads(args.configs), args.solves)
        return
    from .envs.registration import REGISTERED_ENVS

    tasks = args.task or ["PickCube-v1"]
    # this checkout's settings for both checkouts' runs (a prior as a list)
    configs = json.dumps({t: {k: (v.tolist() if hasattr(v, "tolist") else v)
                              for k, v in REGISTERED_ENVS[t]["cls"].MPPI_CONFIG.items()}
                          for t in tasks})
    if args.parent is None:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    roots = dict(parent=args.parent.resolve(), change=ROOT)
    runs = {(t, n): [] for t in tasks for n in roots}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            # -P: the script's own directory (this package, with a `math`
            # subpackage) stays off sys.path; the worker puts its root there
            cmd = [sys.executable, "-P", __file__, "--worker", str(roots[name]),
                   "--solves", str(args.solves), "--configs", configs]
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=roots[name],
                                  env=dict(os.environ, PYTHONPATH=""))
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"the {name} run failed (exit {proc.returncode})")
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    runs[rec["task"], name].append(rec)
                    print(f"{name} {json.dumps(rec)}", flush=True)
    for t in tasks:
        for name in roots:
            recs = runs[t, name]
            mean = {k: statistics.mean(r[k] for r in recs)
                    for k in ("rollouts_per_s", "wall_ms_per_solve", "kernel_ms_per_solve",
                              "pack_ms_per_solve", "unpack_ms_per_solve",
                              "profiled_device_busy_ms", "profiled_device_ops")}
            mean["host_ms_per_solve"] = {n: statistics.mean(r["host_ms_per_solve"][n]
                                                            for r in recs)
                                         for n in recs[0]["host_ms_per_solve"]}
            print(f"[mean] {t} {name} ({len(recs)} runs) {json.dumps(mean)}", flush=True)


if __name__ == "__main__":
    main()
