from .base import Solver, StepOutput, predict_action, shift_plan, warm_start  # noqa: F401
from .mppi import MPPI, MPPIState  # noqa: F401
