from .base import Solver, StepOutput, predict_action, shift_plan, warm_start  # noqa: F401
from .cem import CEM, CEMState  # noqa: F401
from .i2c import I2C, I2CState  # noqa: F401
from .ilqr import ILQR, ILQRState  # noqa: F401
from .mppi import MPPI, MPPIState  # noqa: F401
from .qp_mpc import QPMPC, QPMPCState  # noqa: F401
from .sqp import SQP, SQPState  # noqa: F401
