"""Synthetic test models: identity-dynamics dummy and generic linear systems.

Counterpart of ``benchmarking_mpc_solvers_tpu/models/synthetic.py``.
``DummyModel`` has identity dynamics and the quadratic cost (z-g)ᵀ I (z-g)
over z = (x, u), to isolate solver logic from dynamics.
``make_linear_model`` exists so solvers can be validated against closed-form
finite-horizon LQR solutions.

Neither has a device functor in ``csrc/models.cuh``: the kernels that call a
model's dynamics refuse them by name (``_build.model_id``). The Kalman
filter and smoother kernels see only matrices, so I2C runs them on any model.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Model, quad_cost


def _features(x, u):
    return torch.cat([x, u], dim=-1)


def make_dummy_model(state_size: int, action_size: int) -> Model:
    W = np.eye(state_size + action_size, dtype=np.float32)

    def dynamics(x, u):
        # identity in x, broadcast against u's leading batch dimensions
        return x.expand(torch.broadcast_shapes(x.shape[:-1], u.shape[:-1]) + x.shape[-1:])

    return Model(
        name="dummy",
        state_size=state_size,
        action_size=action_size,
        bounds_low=tuple([-1.0] * action_size),
        bounds_high=tuple([1.0] * action_size),
        dynamics=dynamics,
        transform=_features,
        state_cost=quad_cost(W),
        terminal_cost=quad_cost(W),
    )


DummyModel = make_dummy_model(2, 1)


def make_linear_model(
    A,
    B,
    Q,
    R,
    Qf=None,
    bounds: float = 1e9,
    name: str = "linear",
) -> Model:
    """Linear dynamics x' = A x + B u with cost xᵀQx + uᵀRu.

    The feature vector is z = (x, u) and the cost weight is blockdiag(Q, R)
    (terminal blockdiag(Qf, 0)), so this slots into the same Model contract
    as the physical systems.
    """
    A = np.asarray(A, dtype=np.float32)
    B = np.asarray(B, dtype=np.float32)
    Q = np.asarray(Q, dtype=np.float32)
    R = np.asarray(R, dtype=np.float32)
    Qf = Q if Qf is None else np.asarray(Qf, dtype=np.float32)
    S, na = A.shape[0], B.shape[1]

    W = np.zeros((S + na, S + na), dtype=np.float32)
    W[:S, :S] = Q
    W[S:, S:] = R
    W_T = np.zeros_like(W)
    W_T[:S, :S] = Qf

    on_device: dict = {}  # device -> (Aᵀ, Bᵀ), made once per device

    def dynamics(x, u):
        mats = on_device.get(x.device)
        if mats is None:
            mats = (torch.tensor(A.T.copy(), device=x.device),
                    torch.tensor(B.T.copy(), device=x.device))
            on_device[x.device] = mats
        return x @ mats[0] + u @ mats[1]

    return Model(
        name=name,
        state_size=S,
        action_size=na,
        bounds_low=tuple([-bounds] * na),
        bounds_high=tuple([bounds] * na),
        dynamics=dynamics,
        transform=_features,
        state_cost=quad_cost(W),
        terminal_cost=quad_cost(W_T),
    )
