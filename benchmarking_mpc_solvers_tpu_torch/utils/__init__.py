from .checkpoint import SweepCheckpoint, load_meta, load_pytree, save_pytree  # noqa: F401
from .logging import RunLogger  # noqa: F401
from .profiling import Timer, device_step_latency, slope_timer, trace  # noqa: F401
