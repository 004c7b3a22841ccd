from .fused import fused_rollout_costs_tm, fused_rollout_costs_tm_reference  # noqa: F401
from .fused_mppi import (  # noqa: F401
    fused_mppi_step,
    fused_mppi_step_reference,
    interp_normals,
    pick_lanes,
)
from .rollout import (  # noqa: F401
    best_plan_by_rollout_cost,
    rollout,
    rollout_cost,
    rollout_cost_noisy,
    rollout_noisy,
    simulate_trajectory,
    simulate_trajectory_noisy,
)
