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
    """``jeng._trace_metadata`` replaced by ``trace_metadata`` inside."""
    with mock.patch.object(jeng, "_trace_metadata", trace_metadata):
        yield


@functools.lru_cache(maxsize=None)
def jax_env(task, control_mode, num_envs):
    """A JAX env of ``num_envs`` envs under ``control_mode`` on the XLA
    engine (the plain reference of its Pallas kernel), reset with seed 0:
    its reset outputs in ``reset_out`` and its reset state in
    ``reset_state``. Its jitted env step (``_jit_step``) is shared by the
    modules that ask for the same env in one process."""
    import maniskill_tpu as mst

    env = mst.make(task, num_envs=num_envs, reward_mode="dense", sim_backend="xla",
                   control_mode=control_mode)
    env.reset_out = env.reset(seed=0)
    env.reset_state = env._state
    return env
