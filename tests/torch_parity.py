"""Support for the parity tests of the PyTorch port (``tests/test_torch_*.py``).

The JAX package's ``physics.engine._trace_metadata`` evaluates its
``compute_contacts`` op by op (eagerly) to read the static per-point tables,
and an env build calls it four times: on the CPU that compiles a few hundred
single-op programs, about 10 s of each JAX env the parity tests build.
``fast_trace_metadata`` evaluates the same function once per model as one
jitted program: the same arrays (float32 rounding aside; nothing reads
their values but the tests, at narrowphase tolerance) and the same static
tables, the Python lists taken while tracing. The JAX package is not
changed: the test modules patch the function for their own duration.
"""
import contextlib
import functools
from unittest import mock

import jax
from maniskill_tpu.physics import engine as jeng

_ORIG = jeng._trace_metadata
_CACHE = {}


def trace_metadata(model):
    """``jeng._trace_metadata(model)`` through one jitted program, cached
    per model."""
    hit = _CACHE.get(id(model))
    if hit is not None and hit[0] is model:
        return hit[1]
    static = {}

    def arrays():
        out = _ORIG(model)
        static["tables"] = tuple(out[7:])  # (kind, body) lists of both sides
        return tuple(out[:7])

    res = tuple(jax.jit(arrays)()) + static["tables"]
    _CACHE[id(model)] = (model, res)
    return res


@contextlib.contextmanager
def fast_trace_metadata():
    """``jeng._trace_metadata`` replaced by ``trace_metadata`` inside, also
    in the JAX quadruped tasks' module, which imported it by name for its
    contact masks."""
    from maniskill_tpu.envs.tasks import quadruped

    with mock.patch.object(jeng, "_trace_metadata", trace_metadata), \
            mock.patch.object(quadruped, "_trace_metadata", trace_metadata):
        yield


def make_jax_env(task, **kwargs):
    """``maniskill_tpu.make(task, **kwargs)`` with the env's jitted batch
    step and reset (``_jit_step``, ``_jit_reset``) compiled through
    ``shared_jit``: the same programs, compiled once among the test
    processes."""
    import maniskill_tpu as mst

    env = mst.make(task, **kwargs)
    env._jit_step = shared_jit(jax.vmap(env._step_one))
    env._jit_reset = shared_jit(jax.vmap(lambda k: env._reset_one(k)))
    return env


@functools.lru_cache(maxsize=None)
def jax_env(task, control_mode, num_envs):
    """A JAX env of ``num_envs`` envs under ``control_mode`` on the XLA
    engine (the plain reference of its Pallas kernel), reset with seed 0:
    its reset outputs in ``reset_out`` and its reset state in
    ``reset_state``. Its jitted env step (``_jit_step``) is shared by the
    modules that ask for the same env in one process."""
    env = make_jax_env(task, num_envs=num_envs, reward_mode="dense", sim_backend="xla",
                       control_mode=control_mode)
    env.reset_out = env.reset(seed=0)
    env.reset_state = env._state
    return env


def shared_jit(fn):
    """``jax.jit(fn)`` whose compile of a program is made by one test process
    at a time. Under xdist, neighbouring cases of one task (a step from
    reset and one from contact) often run at once on two workers, and each
    compiled the same JAX program: a minute of XLA work twice. Here the
    first call with new argument shapes lowers the function, and compiles
    it holding a file lock named after the lowered program's text, beside
    the persistent compilation cache: a process that wants the same
    program waits for the first to finish, then reads the compiled program
    from that cache. (Without a cache directory the lock only serializes.)"""
    import fcntl
    import hashlib
    import os
    import tempfile

    import numpy as np

    jitted = jax.jit(fn)
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), str(getattr(x, "dtype", type(x)))) for x in leaves))
        exe = compiled.get(key)
        if exe is None:
            lowered = jitted.lower(*args)
            digest = hashlib.sha256(lowered.as_text().encode()).hexdigest()[:24]
            where = jax.config.jax_compilation_cache_dir or tempfile.gettempdir()
            os.makedirs(where, exist_ok=True)
            with open(os.path.join(where, f"compile-{digest}.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    exe = compiled[key] = lowered.compile()
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        return exe(*args)

    return call


def np_tree(obj):
    """A JAX dataclass/dict nest as dicts of numpy arrays (the PRNG key
    dropped)."""
    import dataclasses

    import numpy as np

    if dataclasses.is_dataclass(obj):
        return {f.name: np_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "rng"}
    if isinstance(obj, dict):
        return {k: np_tree(v) for k, v in obj.items()}
    return None if obj is None else np.asarray(obj)


def to_jax(like, port):
    """A port state moved into the JAX state ``like`` (the PRNG key keeps
    ``like``'s value)."""
    import dataclasses

    import jax.numpy as jnp

    from maniskill_tpu_torch import convert

    if isinstance(like, dict):
        return {k: to_jax(like[k], port[k]) for k in like}
    if not dataclasses.is_dataclass(like):
        return jnp.asarray(convert.to_numpy(port)).astype(like.dtype)
    return like.replace(**{f.name: to_jax(getattr(like, f.name), getattr(port, f.name))
                           for f in dataclasses.fields(like)
                           if getattr(like, f.name) is not None
                           and getattr(port, f.name, None) is not None})


def plain64(kern, sim, cmd, n):
    """The port's plain step of ``n`` sim steps in float64 (torch's default
    dtype switched for the call), as numpy arrays by field: the referee of
    stiff envs."""
    import dataclasses

    import torch

    from maniskill_tpu_torch import convert

    def as64(x):
        return x.replace(**{f.name: v.double() for f in dataclasses.fields(x)
                            if isinstance(v := getattr(x, f.name), torch.Tensor)
                            and v.is_floating_point()})

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return convert.to_numpy(kern.plain(as64(sim), as64(cmd), n)[0])
    finally:
        torch.set_default_dtype(prev)


def jax_step64(jenv, sim, cmd):
    """One control step of the JAX env's engine in float64
    (``jax.enable_x64``), from JAX inputs cast to float64; numpy arrays by
    field."""
    import jax.numpy as jnp
    import numpy as np
    from maniskill_tpu.physics import engine as jeng

    step, n = jeng.make_step_fn(jenv.model), jenv.sim_steps_per_control

    def as64(x):
        return jax.tree.map(
            lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, x)

    with jax.enable_x64(True):
        out = jax.jit(jax.vmap(lambda s, c: step(s, c, n)))(as64(sim), as64(cmd))
        return np_tree(jax.tree.map(np.asarray, out))


def refereed(got, ref, f64, tols, factor=3.0, cap=10.0, jax64=None):
    """Envs where the port's state ``got`` leaves the JAX state ``ref``
    beyond a tolerance (dicts of numpy arrays by field), refereed by the
    port's float64 step ``f64`` (or a function returning it, called only
    where some env leaves a tolerance: the verdict reads the referee in
    those envs alone). In each, field by field, neither float32
    step may be more than ``factor`` times further from the float64 step
    than the other (each distance floored at the tolerance): the port no
    further than JAX, and, since the referee is the port's own step in
    float64, JAX no further than the port, which a fault in the port's
    physics would break in every env it touches. One env of a step may
    reach ``cap`` (float32 rounding in a stiff contact puts one step
    several times further than the other now and then, either way).
    ``jax64``, where given, returns JAX's own step in float64 (called only
    when more than that one env is off): an env where JAX's float32 step is
    the further one then also passes if JAX's float64 step agrees with the
    port's within the tolerance, an independent referee that confirms the
    port's. Returns the refereed envs."""
    import numpy as np

    k = next(iter(got.values())).shape[0]
    out = np.zeros(k, bool)
    j64 = None

    def dist(a, b, name):
        return np.abs(a[name] - b[name]).reshape(k, -1).max(1, initial=0.0)

    if callable(f64):
        if not any((dist(got, ref, name) > tol).any() for name, tol in tols.items()):
            return out
        f64 = f64()
    for name, tol in tols.items():
        err, err64, jerr64 = (dist(a, b, name) for a, b in ((got, ref), (got, f64), (ref, f64)))
        bad = err > tol
        port_r = err64 / np.maximum(jerr64, tol)
        jax_r = jerr64 / np.maximum(err64, tol)
        port_far, jax_far = bad & (port_r > factor), bad & (jax_r > factor)
        if port_far.sum() + jax_far.sum() > 1 and jax_far.any() and jax64 is not None:
            j64 = jax64() if j64 is None else j64
            agree = np.abs(f64[name] - j64[name]).reshape(k, -1).max(1, initial=0.0) <= tol
            jax_far &= ~agree
        assert (np.maximum(port_r, jax_r)[bad] <= cap).all() and (
            port_far.sum() + jax_far.sum() <= 1), (name, err[bad], err64[bad], jerr64[bad])
        out |= bad
    return out


STATE_TOL = dict(qpos=2e-5, qvel=2e-4, free_pose=2e-5, free_vel=5e-4, contact_lam=5e-3,
                 contact_lam_t=5e-3)


def check_tables(tm, jm):
    """The port's model ``tm`` against the JAX model ``jm``: the pair groups
    letter for letter, the per-point side tables, the geoms, the model
    constants, the assignment tables and the static contact tables."""
    import numpy as np

    from maniskill_tpu.physics import engine as jeng_
    from maniskill_tpu_torch.physics import engine as teng

    assert [g[0].__name__ for g in tm.pair_groups] == [g[0].__name__ for g in jm.pair_groups]
    for gt, gj in zip(tm.pair_groups, jm.pair_groups):
        assert gt[1] == gj[1]
        for a, b in zip(gt[2:], gj[2:]):
            np.testing.assert_array_equal(a, b)
    assert len(tm.geoms) == len(jm.geoms)
    for a, b in zip(tm.geoms, jm.geoms):
        assert (a.kind, a.body, int(a.gtype), a.name, a.friction) == (
            b.kind, b.body, int(b.gtype), b.name, b.friction)
        for f in ("size", "offset_p", "offset_q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for name in ("ancestor_mask", "init_qpos", "static_pose", "free_mass", "free_inertia",
                 "drive_kp", "drive_kd", "drive_force_limit", "robot_base_pose", "robot_qlim",
                 "gravity_mask", "robot_inertia_com"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert list(tm.robot.joint_names) == list(jm.robot.joint_names)
    assert tm.robot.link_index == jm.robot.link_index
    for a, b in zip(teng._assignment_tables(tm), jeng_._assignment_tables(jm)):
        np.testing.assert_array_equal(a, b)
    mt, mj = teng._trace_metadata(tm), jeng_._trace_metadata(jm)
    for i in range(3):
        np.testing.assert_allclose(mt[i].numpy(), np.asarray(mj[i]), atol=1e-5)
    for i in range(3, 7):
        np.testing.assert_array_equal(mt[i].numpy(), np.asarray(mj[i]))
    assert list(mt[7]) == list(mj[7]) and list(mt[8]) == list(mj[8])


class PlainStep:
    """The port's plain physics step of a model in ``plain64``'s kernel
    form, for an env whose dispatch took no kernel."""

    def __init__(self, model):
        from maniskill_tpu_torch.physics.engine import make_step_fn

        self._step = make_step_fn(model)

    def plain(self, sim, cmd, n):
        return self._step(sim, cmd, n), None


def compare_env_step(jstep, tenv, st_j, action, label, obs_tol=2e-4, reward_tol=1e-4):
    """One env step of the port (``tenv._step``) from the JAX env state
    ``st_j`` against the JAX env's batched jitted step ``jstep``: the
    command's targets within 1e-6; the physics state at the tolerances of
    tests/test_megakernel.py:48-67 (``STATE_TOL``), an env beyond one
    refereed by the port's plain step in float64 (``refereed``; only envs
    in contact may be); in the envs held, the extras (integers and flags
    exactly), the obs within ``obs_tol``, the reward within ``reward_tol``
    and evaluate's flags exactly. Returns the JAX state after the step and
    the refereed envs."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from maniskill_tpu_torch import convert

    st_t = convert.env_state_from_numpy(np_tree(st_j))
    st_j2, obs_j, rew_j, _term, info_j = jstep(st_j, jnp.asarray(action))
    st_t2, obs_t, rew_t, _term_t, info_t = tenv._step(st_t, torch.as_tensor(action))
    np.testing.assert_allclose(st_t2.cmd.target_qpos.numpy(), np.asarray(st_j2.cmd.target_qpos),
                               atol=1e-6, err_msg=label)
    got, ref = convert.to_numpy(st_t2.sim), np_tree(st_j2.sim)
    kern = tenv.kernel if tenv.kernel is not None else PlainStep(tenv.model)
    bad = refereed(got, ref, lambda: plain64(kern, st_t.sim, st_t2.cmd,
                                             tenv.sim_steps_per_control), STATE_TOL)
    touch = ((st_t.sim.contact_lam > 0).any(1).numpy() | (got["contact_lam"] > 0).any(1)
             | (ref["contact_lam"] > 0).any(1))
    assert not (bad & ~touch).any(), (label, bad, touch)
    held = ~bad
    for name, v in np_tree(st_j2.extras).items():
        t = st_t2.extras[name].numpy()
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(t[held], v[held], rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(t[held], v[held], err_msg=f"{label} {name}")
    assert st_t2.extras.keys() == np_tree(st_j2.extras).keys()
    np.testing.assert_allclose(obs_t.numpy()[held], np.asarray(obs_j)[held], rtol=1e-4,
                               atol=obs_tol, err_msg=f"{label} obs")
    np.testing.assert_allclose(rew_t.numpy()[held], np.asarray(rew_j)[held], atol=reward_tol,
                               err_msg=f"{label} reward")
    assert info_t.keys() == info_j.keys(), label
    for key in info_j:
        a, b = info_t[key].numpy()[held], np.asarray(info_j[key])[held]
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {key}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=obs_tol, err_msg=f"{label} {key}")
    return st_j2, bad


def check_reset_outputs(jenv, tenv, label=""):
    """The port's obs and evaluate on the JAX env's reset state against the
    JAX reset's (``jenv.reset_out``) within 1e-5 relative (1e-6 absolute)."""
    import numpy as np

    from maniskill_tpu_torch import convert
    from maniskill_tpu_torch.envs.base_env import TaskContext

    st = convert.env_state_from_numpy(np_tree(jenv.reset_state))
    ctx = TaskContext(tenv, st)
    info = tenv.evaluate(st, ctx)
    obs = tenv._get_obs(st, ctx, info)
    obs_j, info_j = jenv.reset_out
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), rtol=1e-5, atol=1e-6,
                               err_msg=f"{label} obs")
    assert info.keys() == info_j.keys(), label
    for key in info_j:
        np.testing.assert_allclose(np.asarray(info[key].numpy(), np.float64),
                                   np.asarray(info_j[key], np.float64), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{label} {key}")
