from .base_agent import REGISTERED_AGENTS, BaseAgent, Keyframe, register_agent
from .robots import (cartpole, fetch, panda, panda_stick, quadruped, trifinger,  # noqa: F401
                     widowx, xarm)  # (populates the agent registry)
