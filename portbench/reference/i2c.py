"""I2C (input inference for control) in plain PyTorch: Watson, Abdulsamad &
Peters, "Stochastic Optimal Control as Approximate Input Inference" (CoRL
2019), as iterated Gaussian smoothing of the augmented latent ξ = (x, u).

Each solve runs ``max_iter`` iterations from the carried plan ū, at
temperatures α annealed by ``anneal`` up to ``alpha_max``. An iteration:

- the nominal rollout of ū from the observed state, and around it the
  linearised prior ξ_{t+1} = F_t ξ_t + m_t + w, F_t = [[A_t, B_t], [0, 0]],
  m_t = (c_t, ū_{t+1}) (ū_t with ``prior_lag``; the last row repeats
  ū_{T-1}), w ~ N(0, blockdiag(ε_x I, σ_u² I)), ξ_0 ~ N((x_0, ū_0),
  blockdiag(1e-8 I, σ_u² I));
- the optimality likelihood moment-matched at the nominal: the cost
  features z(ξ) ≈ J_t ξ + z0_t observe the goal with noise
  R = (2α(W + ε_w I))⁻¹, W the stage cost's weight;
- a Kalman filter forward and an RTS smoother back; the smoothed control
  means are the new plan, the old plan kept where they are not finite,
  clipped to the action bounds;
- the line search: the plans ū + γ(ū_new − ū), γ ∈ (1, ½, 0), rolled out
  from the observed state on the true cost; the cheapest wins, the first on
  a tie, a non-finite cost loses.

Departures from the paper, all the program's: the goal is observed through
the features and the temperature is annealed per iteration within one MPC
solve (the paper runs to convergence), the line search is the program's
guard on the true cost, and the derivative of the action clip at the bound
is ½ (the program's ``min(max(u, lo), hi)``, as JAX's clip), where
``torch.clamp`` gives 1.

The bits decide the loop's outcome at these widths: the plans ride the
action bounds, where one rounding moves a clip's derivative, and the line
search picks between costs that round alike (three iterations on cart-pole
can part by O(0.3) where two agree to 2e-5). So the reference takes the
program's order of operations where it decides the bits: the plant's
Jacobians by ``torch.func.jacrev`` of the plant module's functions, the
products with them by ``matmul`` on the whole batch (the matmul's kernel
may follow the batch's shape), every entry of the filter and smoother a sum
from 0 upwards in index order, the Cholesky factors with their diagonals
floored at 1e-30, and the costs summed by ``sum`` over a (B, 3, T) stack.
With ``order="witness"`` the filter's and smoother's sums run from the
last index down: a sound witness of another summation order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacrev, vmap

from .loop import Episodes, PlantNoise, closed_loop

LS_STEPS = (1.0, 0.5, 0.0)  # the line search's step sizes, the solver's class default
CHOL_FLOOR = 1e-30


def cost_weight(plant) -> torch.Tensor:
    """The stage cost's weight W (Z, Z) from the plant's cost terms."""
    Z = plant.S + plant.A
    W = torch.zeros((Z, Z), dtype=torch.float32)
    for i, j, w in plant.COST_TERMS:
        if i == j:
            W[i, i] = w
        else:
            W[i, j] = W[j, i] = 0.5 * w
    return W


def alphas(a: dict) -> list:
    """Each iteration's temperature, annealed in float32."""
    alpha, out = np.float32(a["alpha0"]), []
    for _ in range(a["max_iter"]):
        out.append(alpha)
        alpha = min(np.float32(alpha * np.float32(a["anneal"])), np.float32(a["alpha_max"]))
    return out


def obs_noise(W, alpha, eps_w: float):
    """R = (2α(W + ε_w I))⁻¹, in float32 on the host."""
    Wt = W + eps_w * torch.eye(W.shape[0], dtype=torch.float32)
    return torch.linalg.inv(float(np.float32(2.0) * np.float32(alpha)) * Wt)


def prior_covs(S: int, A: int, a: dict):
    """(Σ_0, Q): the prior's and the process noise's covariances (D, D)."""
    D = S + A
    sig0 = torch.zeros((D, D), dtype=torch.float32)
    Q = torch.zeros((D, D), dtype=torch.float32)
    sig0[:S, :S] = 1e-8 * torch.eye(S)
    Q[:S, :S] = a["eps_x"] * torch.eye(S)
    sig0[S:, S:] = Q[S:, S:] = a["sigma_u"] ** 2 * torch.eye(A)
    return sig0, Q


def rollout(plant, x0, us):
    """States (..., T+1, S) and stage costs (..., T) of plans us (..., T, A)
    from x0, which broadcasts against the plans' leading dimensions."""
    x = x0.expand(us.shape[:-2] + x0.shape[-1:])
    xs, cs = [x], []
    for t in range(us.shape[-2]):
        u = us[..., t, :]
        x, c = plant.dynamics(x, u), plant.stage_cost(x, u)
        xs.append(x)
        cs.append(c)
    return torch.stack(xs, dim=-2), torch.stack(cs, dim=-1)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def linearise(plant, xu):
    """(A (N, S, S), B (N, S, A), c (N, S)) of the dynamics at points xu
    (N, S + A): x' = A x + B u + c, exact at the point. The clip's
    derivative at the bound is ½."""
    S = plant.S
    x, u = xu[:, :S], xu[:, S:]

    def f(v):
        y = plant.dynamics(v[:S], v[S:])
        return y, y

    J, y = vmap(jacrev(f, has_aux=True))(xu)
    on_bound = (u == plant.LO) | (u == plant.HI)
    A = J[:, :, :S]
    B = J[:, :, S:] * torch.where(on_bound, 0.5, 1.0).to(J.dtype)[:, None, :]
    c = y - _mv(A, x) - _mv(B, u)
    return A, B, c


def features_jacobian(plant, xu):
    """(z (N, Z), J (N, Z, D)) of the cost features at points xu (N, D)."""
    S = plant.S

    def f(v):
        z = plant.features(v[:S], v[S:])
        return z, z

    J, z = vmap(jacrev(f, has_aux=True))(xu)
    return z, J


def _sum(terms, order):
    """Σ of the terms from 0 upwards, in index order or (witness) reversed."""
    total = 0.0
    for term in (terms if order == "program" else terms[::-1]):
        total = total + term
    return total


def _mm(a, b, order):
    """a (n, I, K) @ b (n, K, J), each entry summed over k from 0 upwards."""
    return _sum([a[:, :, k:k + 1] * b[:, k:k + 1, :] for k in range(a.shape[2])], order)


def _mvs(a, v, order):
    """a (n, I, K) v (n, K), each entry summed over k from 0 upwards."""
    return _sum([a[:, :, k] * v[:, k:k + 1] for k in range(a.shape[2])], order)


def cholesky(M):
    """Lower factor (n, N, N) of M's lower triangle, column by column, each
    entry's products taken off in k order, the diagonal floored."""
    n, N, _ = M.shape
    L = torch.zeros_like(M)
    for j in range(N):
        s = M[:, j:, j]
        for k in range(j):
            s = s - L[:, j:, k] * L[:, j, k:k + 1]
        d = torch.sqrt(torch.clamp(s[:, 0], min=CHOL_FLOOR))
        L[:, j, j] = d
        L[:, j + 1:, j] = s[:, 1:] / d[:, None]
    return L


def chol_solve(L, b):
    """x = (L Lᵀ)⁻¹ b for each row of b (n, R, N): forward, then back."""
    N = L.shape[1]
    y = [None] * N
    for i in range(N):
        s = b[:, :, i]
        for k in range(i):
            s = s - L[:, i, k:k + 1] * y[k]
        y[i] = s / L[:, i, i:i + 1]
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[:, k, i:i + 1] * x[k]
        x[i] = s / L[:, i, i:i + 1]
    return torch.stack(x, dim=-1)


def kalman_filter(F, m, J, z0, R, mu0, sig0, Q, g, order):
    """The filter over t = 0..T-1, update then prediction: (mu_f, sig_f,
    mu_pred, sig_pred), each a list over t of (n, D) or (n, D, D)."""
    T = F.shape[1]
    mu_p, sig_p = mu0, sig0.expand(mu0.shape[:1] + sig0.shape)
    out = ([], [], [], [])
    for t in range(T):
        Ft, Jt = F[:, t], J[:, t]
        PJ = _mm(sig_p, Jt.transpose(1, 2), order)  # (n, D, Z)
        sig_y = R + _mm(Jt, PJ, order)
        K = chol_solve(cholesky(sig_y), PJ)  # (n, D, Z): PJ sig_y⁻¹
        innov = g[t] - (_mvs(Jt, mu_p, order) + z0[:, t])
        mu_f = mu_p + _mvs(K, innov, order)
        sf = sig_p - _mm(K, PJ.transpose(1, 2), order)
        sig_f = 0.5 * (sf + sf.transpose(1, 2))
        mu_p = m[:, t] + _mvs(Ft, mu_f, order)
        sig_p = _mm(_mm(Ft, sig_f, order), Ft.transpose(1, 2), order) + Q
        for lst, v in zip(out, (mu_f, sig_f, mu_p, sig_p)):
            lst.append(v)
    return out


def rts_smoother(F, mu_f, sig_f, mu_pred, sig_pred, order):
    """Smoothed means (n, T, D): the backward pass over the filter's lists;
    the last row is the filtered mean of t = T-1."""
    T = F.shape[1]
    mu_next, sig_next = mu_f[-1], sig_f[-1]
    out = [mu_next]
    for t in reversed(range(T - 1)):
        M = _mm(F[:, t], sig_f[t], order)
        G = chol_solve(cholesky(sig_pred[t]), M.transpose(1, 2))  # sig_f Fᵀ sig_pred⁻¹
        mu_next = mu_f[t] + _mvs(G, mu_next - mu_pred[t], order)
        GD = _mm(G, sig_next - sig_pred[t], order)
        sig_next = sig_f[t] + _mm(GD, G.transpose(1, 2), order)
        out.append(mu_next)
    return torch.stack(out[::-1], dim=1)


def smooth_once(plant, a: dict, x0, us, alpha, dt, order):
    """The smoothed control means (n, T, A) of one iteration around us."""
    S, A = plant.S, plant.A
    n, T, _ = us.shape
    D = S + A
    xs, _ = rollout(plant, x0, us)
    xu = torch.cat([xs[:, :-1], us], dim=-1).reshape(-1, D)
    Am, Bm, c = linearise(plant, xu)
    z, J = features_jacobian(plant, xu)
    Z = z.shape[-1]
    z0 = (z - _mv(J, xu)).reshape(n, T, Z)
    F = torch.zeros((n, T, D, D), dtype=dt, device=us.device)
    F[:, :, :S, :S] = Am.reshape(n, T, S, S)
    F[:, :, :S, S:] = Bm.reshape(n, T, S, A)
    u_prior = us if a["prior_lag"] else torch.cat([us[:, 1:], us[:, -1:]], dim=1)
    m = torch.cat([c.reshape(n, T, S), u_prior], dim=-1)
    mu0 = torch.cat([xs[:, 0], us[:, 0]], dim=-1)
    dev = us.device
    R = obs_noise(cost_weight(plant), alpha, a["eps_w"]).to(dev, dt)
    sig0, Q = (v.to(dev, dt) for v in prior_covs(S, A, a))
    g = torch.zeros((T, Z), dtype=dt, device=dev)  # the goal: the features' zero
    filt = kalman_filter(F, m, J.reshape(n, T, Z, D), z0, R, mu0, sig0, Q, g, order)
    mu = torch.stack(filt[0], dim=1) if T == 1 else rts_smoother(F, *filt, order)
    return mu[..., S:]


def solve(plant, a: dict, plan, x, dt, order):
    """One I2C solve for n scenarios: plan (n, T, A), x (n, S)."""
    us = plan
    for alpha in alphas(a):
        new = smooth_once(plant, a, x, us, alpha, dt, order)
        finite = torch.isfinite(new).flatten(1).all(dim=1)
        new = torch.clamp(torch.where(finite[:, None, None], new, us), plant.LO, plant.HI)
        if a["line_search"]:
            cands = torch.stack([us + g * (new - us) for g in LS_STEPS], dim=1)
            _, cs = rollout(plant, x[:, None], cands)
            costs = cs.sum(dim=-1)
            costs = torch.where(torch.isfinite(costs), costs, torch.inf)
            new = cands[torch.arange(cands.shape[0], device=x.device), torch.argmin(costs, dim=-1)]
        us = new
    return us, us[:, 0, 0]


def episodes(plant, solver: dict, traffic: dict, inputs, idx, dt=torch.float32,
             order="program"):
    """The episodes of scenarios ``idx`` of one batch (``inputs``: the
    batch's x0s, per-call seeds and plant seed, as the benchmark made them).
    The whole batch is solved: the matmuls' kernels may follow its shape."""
    if traffic.get("model_noise_std", 0.0) or solver.get("init_std", 0.0):
        raise NotImplementedError("the I2C reference covers the noiseless planning model "
                                  "from a zero plan")
    B, dev = traffic["batch"], inputs.x0s.device
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    plant_noise = PlantNoise(inputs.plant_seed, B, plant.S, torch.arange(B, device=dev), dev)

    def step(_, plan, obs):
        return solve(plant, solver, plan, obs, dt, order)
    init = torch.zeros((B, solver["T"], plant.A), dtype=dt, device=dev)
    ep = closed_loop(plant, inputs.x0s, traffic["steps"], step, init,
                     traffic.get("sensor_std", 0.0), plant_noise, dt)
    return Episodes(*(f[idx_t] for f in ep))
