from .fused import fused_rollout_costs_tm, fused_rollout_costs_tm_reference  # noqa: F401
from .fused_cem import fused_cem_step, fused_cem_step_reference  # noqa: F401
from .fused_linesearch import (  # noqa: F401
    fused_linesearch,
    fused_linesearch_reference,
    linesearch_applicable,
)
from .fused_mppi import (  # noqa: F401
    fused_mppi_step,
    fused_mppi_step_reference,
    interp_normals,
    pick_lanes,
    scenario_normals,
)
from .riccati_backward import (  # noqa: F401
    pallas_riccati_applicable,
    riccati_backward_batch,
    riccati_backward_batch_reference,
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
