"""maniskill_tpu_torch: the PyTorch/CUDA port of maniskill_tpu.

The port runs on an NVIDIA GPU: its physics step is a hand-written CUDA
kernel (``physics/megakernel.py``, ``csrc/megakernel.cu``) with a plain
PyTorch version beside it for CPU tensors. It imports no JAX and nothing
of the ``maniskill_tpu`` package; robot assets are read from that
package's asset tree as data files.

    import maniskill_tpu_torch as mtt
    env = mtt.make("PickCube-v1", num_envs=1)        # device "cuda"
    env = mtt.make("PickCube-v1", num_envs=4, device="cpu")
"""
from .envs.registration import REGISTERED_ENVS, make, register_env
from . import agents  # noqa: F401  (populates the agent registry)
from .envs import tasks  # noqa: F401  (registers the tasks)

__all__ = ["REGISTERED_ENVS", "make", "register_env"]
