"""Trajectory linearization / quadratization.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/linearize.py``: the
time-varying affine dynamics

    x_{t+1} ≈ A_t x_t + B_t u_t + c_t

and quadratic cost expansions around a nominal trajectory, by
``torch.func``. Where the reference vmaps over the horizon (and its callers
over scenarios), every function here takes any leading batch dimensions:
``xs`` (..., T, S), ``us`` (..., T, A), ``g_z`` (T, Z) or (..., T, Z). The
points are flattened to one (N, ·) batch, differentiated under one ``vmap``
and reshaped.

Jacobians are taken in reverse mode (``jacrev``): forward mode carries the
tangent of a 0-dim tensor times a Python float in float64 in this PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian, jacrev, vmap

from ..models.base import Model


class AffineDynamics(NamedTuple):
    A: torch.Tensor  # (..., T, S, S)
    B: torch.Tensor  # (..., T, S, A)
    c: torch.Tensor  # (..., T, S) residual: x' = A x + B u + c is exact at the point


class QuadCost(NamedTuple):
    Q: torch.Tensor  # (..., T, S, S)
    R: torch.Tensor  # (..., T, A, A)
    M: torch.Tensor  # (..., T, A, S) cross term
    q: torch.Tensor  # (..., T, S)
    r: torch.Tensor  # (..., T, A)
    Qf: torch.Tensor  # (..., S, S)
    qf: torch.Tensor  # (..., S)


def mT(m):
    """Transpose of the last two dimensions."""
    return m.transpose(-1, -2)


def mv(m, v):
    """Batched matrix-vector product over the last dimensions."""
    return (m @ v[..., None])[..., 0]


def _sym_weight(cost_fn, device):
    """0.5·(W + Wᵀ) of a ``quad_cost`` as a float32 tensor on ``device``."""
    W = torch.as_tensor(cost_fn.W, dtype=torch.float32, device=device)
    return 0.5 * (W + W.T)


def _transform_jacobian(model: Model, xu):
    """(z, J) of the feature transform at flat points xu (N, S+A)."""
    S = model.state_size

    def z_of(v):
        z = model.transform(v[:S], v[S:])
        return z, z

    J, z = vmap(jacrev(z_of, has_aux=True))(xu)
    return z, J


def linearize_dynamics(model: Model, xs, us) -> AffineDynamics:
    """Jacobians of the dynamics along (xs, us), xs (..., T, S) the points
    (the caller passes ``xs[..., :-1, :]`` of a trajectory), us (..., T, A).
    One primal evaluation per point serves the Jacobian and the residual."""
    S, A = model.state_size, model.action_size
    lead = us.shape[:-1]
    xu = torch.cat([xs, us], dim=-1).reshape(-1, S + A)

    def f(v):
        y = model.dynamics(v[:S], v[S:])
        return y, y

    J, y = vmap(jacrev(f, has_aux=True))(xu)
    fx, fu = J[:, :, :S], J[:, :, S:]
    c = y - mv(fx, xu[:, :S]) - mv(fu, xu[:, S:])
    return AffineDynamics(fx.reshape(lead + (S, S)), fu.reshape(lead + (S, A)),
                          c.reshape(lead + (S,)))


def gn_point_terms(model: Model, x, u, gz):
    """Closed-form Gauss-Newton expansion of the stage cost at points x
    (..., S), u (..., A) against gz (..., Z): ``grad = 2 Jᵀ W_sym (z−g)``,
    ``H = 2 Jᵀ W_sym J`` with the model's ``quad_cost`` weight and J the
    transform Jacobian. It keeps a live gradient where the clipped cost has
    saturated at ±1e30. Requires ``model.state_cost.W``.
    Returns (grad (..., S+A), H (..., S+A, S+A))."""
    S, A = model.state_size, model.action_size
    lead = x.shape[:-1]
    Wsym = _sym_weight(model.state_cost, x.device)
    xu = torch.cat([x, u], dim=-1).reshape(-1, S + A)
    z, J = _transform_jacobian(model, xu)
    zd = z - gz.expand(lead + gz.shape[-1:]).reshape(z.shape)
    g = 2.0 * mv(mT(J), zd @ Wsym)
    H = 2.0 * (mT(J) @ Wsym @ J)
    return g.reshape(lead + (S + A,)), H.reshape(lead + (S + A, S + A))


def gn_terminal_terms(model: Model, x, g_last):
    """Closed-form GN terminal expansion at x (..., S) with zero action
    against g_last (Z,) or (..., Z): ``qf = 2 Jfᵀ W_sym (z−g)``,
    ``Qf = 2 Jfᵀ W_sym Jf`` from ``model.terminal_cost.W``. Returns (qf (..., S), Qf (..., S, S))."""
    S = model.state_size
    lead = x.shape[:-1]
    WfT = _sym_weight(model.terminal_cost, x.device)

    def zf(v):
        z = model.transform(v, v.new_zeros((model.action_size,)))
        return z, z

    Jf, zT = vmap(jacrev(zf, has_aux=True))(x.reshape(-1, S))
    zd = zT - g_last.expand(lead + g_last.shape[-1:]).reshape(zT.shape)
    qf = 2.0 * mv(mT(Jf), zd @ WfT)
    Qf = 2.0 * (mT(Jf) @ WfT @ Jf)
    return qf.reshape(lead + (S,)), Qf.reshape(lead + (S, S))


def quadratize_cost(model: Model, xs, us, g_z, gauss_newton: bool = True) -> QuadCost:
    """Second-order cost expansion along trajectories xs (..., T+1, S), us
    (..., T, A) against g_z (T, Z) or (..., T, Z).

    ``gauss_newton=True`` drops the transform's curvature (PSD-guaranteed);
    with ``quad_cost`` costs (a ``.W``) it is the closed form of
    ``gn_point_terms``/``gn_terminal_terms``, otherwise W is recovered from
    the outer cost's curvature. ``False`` uses the full Hessian."""
    S, A = model.state_size, model.action_size
    lead = us.shape[:-2]
    T = us.shape[-2]
    Z = g_z.shape[-1]
    gz = g_z.expand(lead + (T, Z))
    g_last = gz[..., -1, :]
    x_pts = xs[..., :-1, :]

    if gauss_newton and getattr(model.state_cost, "W", None) is not None:
        g, H = gn_point_terms(model, x_pts, us, gz)
    else:
        xu = torch.cat([x_pts, us], dim=-1).reshape(-1, S + A)
        gzf = gz.reshape(-1, Z)

        def c_fn(v, g_):
            return model.cost(v[:S], v[S:], g_)

        g = vmap(grad(c_fn))(xu, gzf)
        if gauss_newton:
            # Jᵀ W J with W recovered from the outer cost's curvature
            z, J = _transform_jacobian(model, xu)
            W = vmap(hessian(model.state_cost))(z, gzf) / 2.0
            H = 2.0 * mT(J) @ W @ J
        else:
            H = vmap(hessian(c_fn))(xu, gzf)
        g = g.reshape(lead + (T, S + A))
        H = H.reshape(lead + (T, S + A, S + A))
    q, r = g[..., :S], g[..., S:]
    Q, R, M = H[..., :S, :S], H[..., S:, S:], H[..., S:, :S]

    xT = xs[..., -1, :]
    if gauss_newton and getattr(model.terminal_cost, "W", None) is not None:
        qf, Qf = gn_terminal_terms(model, xT, g_last)
    else:
        xTf = xT.reshape(-1, S)
        gl = g_last.expand(lead + (Z,)).reshape(-1, Z)
        qf = vmap(grad(model.final_cost))(xTf, gl)
        if gauss_newton:
            # the same drop of feature curvature for the terminal stage:
            # exact terminal Hessians of the nonlinear feature costs are
            # indefinite far from the goal and poison the Riccati seed
            def zf(v):
                z = model.transform(v, v.new_zeros((A,)))
                return z, z

            Jf, zT = vmap(jacrev(zf, has_aux=True))(xTf)
            Wf = vmap(hessian(model.terminal_cost))(zT, gl) / 2.0
            Qf = 2.0 * mT(Jf) @ Wf @ Jf
        else:
            Qf = vmap(hessian(model.final_cost))(xTf, gl)
        qf, Qf = qf.reshape(lead + (S,)), Qf.reshape(lead + (S, S))
    return QuadCost(Q, R, M, q, r, Qf, qf)
