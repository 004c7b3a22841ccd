"""benchmarking_mpc_solvers_tpu_torch — the MPC solver engine on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``benchmarking_mpc_solvers_tpu`` (JAX/Pallas on TPU), which stays
the reference. This package imports neither JAX nor the reference package.
Its module layout mirrors the reference's; entry points take an explicit
``device`` (default ``"cuda"``, which raises when CUDA is absent) and
``torch.Generator``s for all randomness. Kernel wrappers launch their CUDA
kernel on CUDA tensors and run their plain PyTorch version on CPU tensors.
"""

from .models import (  # noqa: F401
    AcrobotModel,
    CartPoleSwingUpModel,
    DummyModel,
    Model,
    PendulumModel,
    make_linear_model,
)
from .solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP  # noqa: F401

__version__ = "0.1.0"
