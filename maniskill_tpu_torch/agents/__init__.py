from .base_agent import REGISTERED_AGENTS, BaseAgent, Keyframe, register_agent
from .robots import panda  # noqa: F401  (populates the agent registry)
