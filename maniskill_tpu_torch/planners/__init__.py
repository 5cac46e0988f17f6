from .mppi import MPPI, MPPIConfig, MPPIState
