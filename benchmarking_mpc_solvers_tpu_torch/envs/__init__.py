from .env import (  # noqa: F401
    AcrobotEnv,
    CartPoleSwingUpEnv,
    Env,
    EnvStep,
    NoiseConfig,
    PendulumEnv,
    REGISTRY,
    env_step,
)
from .render import render_episode, render_state  # noqa: F401
from .gym_wrapper import (  # noqa: F401
    GymEnvModel,
    GymWrapperEnv,
    HAVE_GYMNASIUM,
    MujocoWrapperEnv,
)
