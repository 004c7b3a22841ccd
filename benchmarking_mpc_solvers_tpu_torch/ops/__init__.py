from .fused import (  # noqa: F401
    fused_rollout_cost_samples,
    fused_rollout_cost_samples_reference,
    fused_rollout_costs,
    fused_rollout_costs_reference,
    fused_rollout_costs_tm,
    fused_rollout_costs_tm_reference,
)
from .fused_cem import fused_cem_step, fused_cem_step_reference  # noqa: F401
from .fused_derivs import fused_derivs, fused_derivs_reference  # noqa: F401
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
    scenario_normals_reference,
)
from .i2c_smooth import (  # noqa: F401
    i2c_filter,
    i2c_filter_reference,
    i2c_rts_smooth,
    i2c_rts_smooth_reference,
    i2c_smooth_batch,
    i2c_smooth_batch_reference,
)
from .linearize import (  # noqa: F401
    AffineDynamics,
    QuadCost,
    gn_point_terms,
    gn_terminal_terms,
    linearize_dynamics,
    quadratize_cost,
)
from .qp import (  # noqa: F401
    ADMMResult,
    CondensedQP,
    CondensedQPBatch,
    admm_solve,
    admm_solve_riccati,
    admm_solve_riccati_batch,
    condense,
    condense_batch,
    ip_solve,
    kkt_residual,
    qp_objective,
)
from .qp_admm import admm_iterate, admm_iterate_reference  # noqa: F401
from .riccati import (  # noqa: F401
    RiccatiFactors,
    TVLQRPolicy,
    associative_scan,
    riccati_factors,
    tvlqr_backward,
    tvlqr_backward_assoc,
    tvlqr_backward_assoc_general,
    tvlqr_rollout,
    tvlqr_solve,
    tvlqr_solve_linear_batch,
    tvlqr_values_assoc,
)
from .riccati_backward import (  # noqa: F401
    pallas_riccati_applicable,
    riccati_backward_batch,
    riccati_backward_batch_reference,
    tvlqr_backward_cv,
)
from .rollout import (  # noqa: F401
    best_plan_by_rollout_cost,
    rollout,
    rollout_cost,
    rollout_cost_noisy,
    rollout_cost_samples,
    rollout_noisy,
    simulate_trajectory,
    simulate_trajectory_noisy,
)
