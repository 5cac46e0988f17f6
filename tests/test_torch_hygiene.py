"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never slips onto the CPU without being asked."""
import os
import subprocess
import sys

import pytest
import torch

import maniskill_tpu_torch as mtt

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import numpy
import maniskill_tpu_torch
import maniskill_tpu_torch.convert, maniskill_tpu_torch.planners.mppi
import maniskill_tpu_torch.planners.cem, maniskill_tpu_torch.planners.ilqr
import maniskill_tpu_torch.planners.mpc
import maniskill_tpu_torch.physics.megakernel, maniskill_tpu_torch.physics.solve_kernel
import maniskill_tpu_torch.envs.tasks.stack_cube, maniskill_tpu_torch.kernel_ab
import maniskill_tpu_torch.envs.tasks.pick_single_hull, maniskill_tpu_torch.envs.tasks.ycb_variants
import maniskill_tpu_torch.physics.hulls, maniskill_tpu_torch.utils.building
import maniskill_tpu_torch.math.clamps
import maniskill_tpu_torch.envs.tasks.plug_charger, maniskill_tpu_torch.envs.tasks.tabletop_extra
import maniskill_tpu_torch.agents.robots.panda, maniskill_tpu_torch.agents.robots.xarm
import maniskill_tpu_torch.envs.tasks.rotate_in_hand
import maniskill_tpu_torch.envs.tasks.articulated, maniskill_tpu_torch.envs.tasks.fold_suitcase
import maniskill_tpu_torch.agents.robots.fetch, maniskill_tpu_torch.kinematics.articulation
import maniskill_tpu_torch.mppi_ab
import maniskill_tpu_torch.kinematics.mjcf, maniskill_tpu_torch.agents.robots.cartpole
import maniskill_tpu_torch.envs.tasks.cartpole, maniskill_tpu_torch.envs.tasks.control_suite
import maniskill_tpu_torch.agents.controllers.ee
import maniskill_tpu_torch.examples.motionplanning.solutions
import maniskill_tpu_torch.examples.motionplanning.run
maniskill_tpu_torch.utils.building.ycb_or_procedural_library()
maniskill_tpu_torch.make("RotateSingleObjectInHandLevel2-v1", num_envs=2, device="cpu").reset(seed=0)
maniskill_tpu_torch.make("OpenCabinetDrawer-v1", num_envs=2, device="cpu").reset(seed=0)
maniskill_tpu_torch.make("MS-HumanoidStand-v1", num_envs=2, device="cpu").reset(seed=0)
maniskill_tpu_torch.make("MS-CartpoleBalance-v1", num_envs=2, device="cpu").reset(seed=0)
_e = maniskill_tpu_torch.make("PullCubeTool-v1", num_envs=2, device="cpu",
                              control_mode="pd_ee_delta_pose")
_e.reset(seed=0)
_e.step(numpy.zeros(7, "float32"))
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
    for task in ("PlugCharger-v1", "RollBall-v1", "RotateSingleObjectInHandLevel2-v1",
                 "FoldSuitcase-v1", "TurnFaucet-v1", "OpenCabinetDrawer-v1",
                 "MS-HumanoidStand-v1", "MS-CartpoleBalance-v1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mtt.make(task, num_envs=1)
