from .cem import CEM, CEMConfig, CEMState
from .ilqr import ILQR, ILQRConfig
from .mpc import CEMILQR, CEMILQRConfig, make_planner, run_episode, solve_task
from .mppi import MPPI, MPPIConfig, MPPIState
