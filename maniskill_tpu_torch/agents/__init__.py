from .base_agent import REGISTERED_AGENTS, BaseAgent, Keyframe, register_agent
from .robots import cartpole, fetch, panda, panda_stick, xarm  # noqa: F401  (populates the agent registry)
