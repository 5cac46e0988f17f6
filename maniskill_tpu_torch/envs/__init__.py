from .base_env import BaseEnv, EnvState, TaskContext, flatten_state_dict
from .registration import REGISTERED_ENVS, make, register_env
