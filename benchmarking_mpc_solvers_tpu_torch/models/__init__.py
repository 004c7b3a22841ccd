from .acrobot import AcrobotModel  # noqa: F401
from .base import Model, nonzero_pairs, quad_cost  # noqa: F401
from .cartpole import CartPoleSwingUpModel  # noqa: F401
from .pendulum import PendulumModel  # noqa: F401

REGISTRY = {
    "pendulum": PendulumModel,
    "cartpole_swingup": CartPoleSwingUpModel,
    "acrobot": AcrobotModel,
}
