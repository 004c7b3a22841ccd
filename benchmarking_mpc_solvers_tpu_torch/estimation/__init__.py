from .cubature import (  # noqa: F401
    UKFModel,
    default_sigma_points,
    make_pendulum_ukf,
    ukf_filter,
    ukf_smoother,
)
from .kalman import (  # noqa: F401
    FilterResult,
    LGSSM,
    SmootherResult,
    kalman_filter,
    kalman_smooth,
    rts_smoother,
)
from .quadrature import SigmaPoints, make_sigma_points, moments, propagate  # noqa: F401
