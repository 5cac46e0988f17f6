"""Receding-horizon MPC driver and the CEM + iLQR planner.

Port of ``maniskill_tpu/planners/mpc.py``: ``CEMILQRConfig``, ``CEMILQR``
(BASELINE config #3: a CEM solve proposes a nominal sequence, iLQR refines
it through the differentiable physics step, and the refined sequence is
executed and shifted into the CEM state, ``:99-114``), ``make_planner``
(``mppi``, ``cem``, ``cem-ilqr``), ``run_episode``, ``run_episode_device``
(the fused episode: one CUDA graph a control step on a card) and
``solve_task``. The port runs the JAX "split" mode: CEM and iLQR are two
host-sequenced calls, as eager PyTorch is anyway. Not ported yet: the
multi-chip mesh argument.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Any, ContextManager, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cem import CEM, CEMConfig, CEMState
from .ilqr import ILQR, ILQRConfig
from ..physics.model import tree_map
from .mppi import MPPI, MPPIConfig


class CEMILQRConfig(NamedTuple):
    cem: CEMConfig = CEMConfig()
    ilqr: ILQRConfig = ILQRConfig()


class CEMILQR:
    """CEM warm start + iLQR refinement; the planner state is the CEM
    state."""

    def __init__(self, env, config: CEMILQRConfig = CEMILQRConfig()):
        if config.cem.horizon != config.ilqr.horizon:
            raise ValueError(f"CEM horizon {config.cem.horizon} != iLQR horizon "
                             f"{config.ilqr.horizon}")
        self.env = env
        self.config = config
        self.action_dim = env.action_dim
        self.cem = CEM(env, config.cem)
        self.ilqr = ILQR(env, config.ilqr)

    def init(self, seed: int = 0) -> CEMState:
        return self.cem.init(seed=seed)

    def plan_step(self, ps: CEMState, env_state):
        ps2, cinfo = self.cem.solve(ps, env_state)
        U, rinfo = self.ilqr.solve(env_state, ps2.mean)
        info = dict(cem_best_return=cinfo["best_return"],
                    ilqr_initial_cost=rinfo["initial_cost"],
                    ilqr_final_cost=rinfo["final_cost"])
        return self.cem.shift(ps2, U), U[0], info


def make_planner(env, planner: str = "mppi", config=None):
    if planner == "mppi":
        return MPPI(env, config or MPPIConfig())
    if planner == "cem":
        return CEM(env, config or CEMConfig())
    if planner == "cem-ilqr":
        return CEMILQR(env, config or CEMILQRConfig())
    raise ValueError(f"unknown planner {planner!r}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_episode(env, planner_obj, seed: int = 0, max_steps: Optional[int] = None,
                stop_on_success: bool = True) -> Dict[str, Any]:
    """One receding-horizon episode on a ``num_envs=1`` env: success,
    steps, return, the executed actions (T, A) and the replanning rate
    after the first plan step (synchronized wall time of ``plan_step``)."""
    if env.num_envs != 1:
        raise ValueError("the MPC driver plans for a single env")
    max_steps = max_steps or env.max_episode_steps or 50
    env.reset(seed=seed)
    ps = planner_obj.init(seed=seed)
    actions, rewards, infos = [], [], []
    success = False
    plan_wall, plans_timed = 0.0, 0
    for t in range(max_steps):
        t0 = time.perf_counter()
        ps, action, _ = planner_obj.plan_step(ps, env._state)
        _sync(env.device)
        if t > 0:  # the first plan step pays the kernel build
            plan_wall += time.perf_counter() - t0
            plans_timed += 1
        _obs, reward, _term, _trunc, step_info = env.step(action)
        actions.append(action.detach().cpu().numpy())
        rewards.append(float(reward[0]))
        infos.append({k: v[0].cpu().numpy() for k, v in step_info.items()})
        if bool(step_info["success"][0]):
            success = True
            if stop_on_success:
                break
    return dict(success=success, steps=len(actions),
                episode_return=float(np.sum(rewards)),
                actions=np.stack(actions) if actions else np.zeros((0, env.action_dim)),
                rewards=np.asarray(rewards), final_info=infos[-1] if infos else {},
                seed=seed, replan_hz=(plans_timed / plan_wall) if plan_wall > 0 else 0.0)


def _copy_into(dst, src):
    """Copy a nest's tensors into the matching tensors of ``dst``."""
    tree_map(lambda d, x: d.copy_(x), dst, src)


class _KernelNodeParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_census(graph) -> Tuple[Optional[int], Optional[Dict[str, int]]]:
    """The node count of a captured ``torch.cuda.CUDAGraph`` kept with
    ``keep_graph=True``, and its kernel nodes counted by function name
    (mangled), read from the graph through libcuda; ``None`` where the
    graph or a call is not available."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
            return None, None
    except (AttributeError, OSError, RuntimeError):
        return None, None
    try:
        get_params, func_name, kernel_name = (
            cu.cuGraphKernelNodeGetParams_v2, cu.cuFuncGetName, cu.cuKernelGetName)
    except AttributeError:
        return int(n.value), None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        return int(n.value), None
    kernels: Dict[str, int] = {}
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    for node in nodes:
        node = ctypes.c_void_p(node)
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            return int(n.value), None
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        if get_params(node, ctypes.byref(params)) != 0:
            return int(n.value), None
        err = (func_name(ctypes.byref(name), ctypes.c_void_p(params.func)) if params.func
               else kernel_name(ctypes.byref(name), ctypes.c_void_p(params.kern)))
        if err != 0:
            return int(n.value), None
        key = name.value.decode()
        kernels[key] = kernels.get(key, 0) + 1
    return int(n.value), kernels


def run_episode_device(env, planner_obj, seed: int = 0, max_steps: Optional[int] = None,
                       stats: Optional[dict] = None,
                       around_replays: Optional[ContextManager] = None) -> Dict[str, Any]:
    """One receding-horizon episode with plan and step fused and no host
    round trip per control step (the JAX ``run_episode_device``,
    ``mpc.py:184-257``): after success the env state and the planner state
    freeze, and the step's action and reward are zero; ``steps`` comes from
    the per-step success flags, read once at the end.

    On a CUDA device one control step (the planner's ``plan_step`` with
    its noise draw, the env's batched ``_step``, the freeze) is captured as
    one CUDA graph that reads the env state, the planner state and the
    done flag from static tensors and writes them back, and the graph is
    replayed ``max_steps`` times; each replay's action, reward and success
    are copied on the device into (T, ...) buffers, and the loop runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronization
    in it raises. One eager step before the capture builds the kernels and
    uploads the constants; the planner's generator (registered with the
    graph, so that each replay draws fresh noise) and the env state are
    restored after it, so the episode is the one eager ``run_episode``
    runs. A failed capture raises. On the CPU the same step runs eagerly,
    ``max_steps`` times, and nothing is read to the host until the end.

    Returns the ``run_episode`` keys; ``replan_hz`` is ``max_steps`` over
    the wall time of the replays (of the eager loop on the CPU). ``stats``,
    where given, receives ``graph_nodes``, ``graph_kernels`` (the graph's
    kernel nodes by function name: each replay launches each of them once)
    and ``capture_s`` (warm-up step and capture). ``around_replays``, where
    given, is a context manager (such as a ``torch.profiler.profile``)
    entered around the replays only, not the warm-up or the capture. The
    kernels' launch counters count the warm-up's and the capture's calls:
    the graph's replays launch without the wrappers."""
    if env.num_envs != 1:
        raise ValueError("the device episode plans for a single env")
    max_steps = max_steps or env.max_episode_steps or 50
    dev = env.device
    env.reset(seed=seed)
    # the episode's state, in distinct tensors that each control step reads
    # and writes back: (planner state, env state, done)
    static = dict(ps=tree_map(torch.clone, planner_obj.init(seed=seed)),
                  state=tree_map(torch.clone, env._state),
                  done=torch.zeros((), dtype=torch.bool, device=dev))

    def control_step():
        """Plan, step, freeze; returns the step's (action, reward, success)."""
        done = static["done"]
        ps2, action, _ = planner_obj.plan_step(static["ps"], static["state"])
        state2, _obs, reward, _term, info = env._step(static["state"], action[None])
        succ = info["success"][0]
        out = (torch.where(done, torch.zeros_like(action), action),
               torch.where(done, torch.zeros_like(reward[0]), reward[0]), succ | done)
        # the new state where not done, the old one where done
        new = tree_map(lambda n, o: torch.where(done, o, n),
                       dict(ps=ps2, state=state2, done=done | succ), static)
        _copy_into(static, new)
        return out

    buffers = (torch.zeros(max_steps, env.action_dim, device=dev),
               torch.zeros(max_steps, device=dev),
               torch.zeros(max_steps, dtype=torch.bool, device=dev))
    if around_replays is None:
        around_replays = contextlib.nullcontext()
    with torch.no_grad():
        if dev.type == "cuda":
            wall = _replay_episode(dev, control_step, static, max_steps, buffers, stats,
                                   around_replays)
        else:
            with around_replays:
                t0 = time.perf_counter()
                for t in range(max_steps):
                    for buf, x in zip(buffers, control_step()):
                        buf[t].copy_(x)
                wall = time.perf_counter() - t0
    env._state = static["state"]
    acts, rews, succs = (b.cpu().numpy() for b in buffers)
    success = bool(succs.any())
    steps = int(np.argmax(succs)) + 1 if success else max_steps
    rewards = rews[:steps]
    return dict(success=success, steps=steps, episode_return=float(rewards.sum()),
                actions=acts[:steps], rewards=rewards, final_info={},
                seed=seed, replan_hz=max_steps / wall)


def _replay_episode(dev, control_step, static, max_steps, buffers, stats, around_replays):
    """``run_episode_device``'s loop as replays of one CUDA graph of
    ``control_step``; returns the replays' wall time."""
    gen = static["ps"].generator
    gen_state = gen.get_state()
    saved = tree_map(torch.clone, static)
    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up: builds, uploads, lazy inits
        control_step()
        _copy_into(static, saved)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    gen.set_state(gen_state)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=side):
        out = control_step()
    nodes, kernels = _graph_census(graph)
    graph.instantiate()
    torch.cuda.synchronize(dev)
    gen.set_state(gen_state)
    capture_s = time.perf_counter() - t0
    with around_replays:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            for t in range(max_steps):
                graph.replay()
                for buf, x in zip(buffers, out):
                    buf[t].copy_(x)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if stats is not None:
        stats.update(graph_nodes=nodes, graph_kernels=kernels, capture_s=capture_s)
    return wall


def solve_task(env_id: str, planner: str = "mppi", config=None, episodes: int = 5,
               seed: int = 0, max_steps: Optional[int] = None,
               env_kwargs: Optional[dict] = None, device_loop: bool = False) -> Dict[str, Any]:
    """``episodes`` seeded receding-horizon episodes of a registered task;
    returns the success rate and the per-episode results. ``env_kwargs``
    go to ``make`` (``device="cpu"`` for the plain step on the CPU);
    ``device_loop`` runs each episode with ``run_episode_device``."""
    from ..envs.registration import make

    kwargs = dict(num_envs=1, obs_mode="none", reward_mode="dense")
    kwargs.update(env_kwargs or {})
    env = make(env_id, **kwargs)
    planner_obj = make_planner(env, planner, config)
    runner = run_episode_device if device_loop else run_episode
    results = [runner(env, planner_obj, seed=seed + i, max_steps=max_steps)
               for i in range(episodes)]
    out = dict(env_id=env_id, planner=planner,
               success_rate=float(np.mean([r["success"] for r in results])),
               mean_return=float(np.mean([r["episode_return"] for r in results])),
               mean_steps=float(np.mean([r["steps"] for r in results])),
               episodes=results)
    hzs = [r["replan_hz"] for r in results if r["replan_hz"]]
    if hzs:
        out["replan_hz"] = float(np.mean(hzs))
    return out
