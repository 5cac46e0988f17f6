"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never slips onto the CPU without being asked."""
import os
import subprocess
import sys

import pytest
import torch

import maniskill_tpu_torch as mtt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import maniskill_tpu_torch
import maniskill_tpu_torch.convert, maniskill_tpu_torch.planners.mppi
import maniskill_tpu_torch.planners.cem, maniskill_tpu_torch.planners.ilqr
import maniskill_tpu_torch.planners.mpc
import maniskill_tpu_torch.physics.megakernel, maniskill_tpu_torch.physics.solve_kernel
import maniskill_tpu_torch.envs.tasks.stack_cube, maniskill_tpu_torch.kernel_ab
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "maniskill_tpu" or m.startswith("maniskill_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_make_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mtt.make("PickCube-v1", num_envs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mtt.make("PickCube-v1", num_envs=1, device="cuda")
    assert mtt.make("PickCube-v1", num_envs=1, device="cpu").device.type == "cpu"
