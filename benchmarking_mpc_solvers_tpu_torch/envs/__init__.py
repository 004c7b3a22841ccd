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
