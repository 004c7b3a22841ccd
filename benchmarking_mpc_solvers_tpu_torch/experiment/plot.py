"""Result plots.

Counterpart of ``benchmarking_mpc_solvers_tpu/experiment/plot.py``: stacked
per-state, per-action, cost and solve-time axes from a result dict, with an
optional overlay of every intermediate MPC plan at its start step, a
multi-solver comparison on shared axes, median and quartile bands across a
sweep, and the iLQR line-search debug figures. Works on the result dicts of
``Experiment.run`` or of ``ResultStore.find``. Needs matplotlib (``Agg``),
which this package imports only here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _dims(result: Dict) -> tuple:
    states = np.asarray(result["env_states"])
    actions = np.asarray(result["env_actions"])
    if actions.ndim == 1:
        actions = actions[:, None]
    return states, actions


def plot_experiment(
    result: Dict,
    figsize=(14, 14),
    plot_planning: bool = False,
    fig: Optional[plt.Figure] = None,
):
    """One experiment: S state rows + A action rows + cost + solve-time."""
    states, actions = _dims(result)
    costs = np.asarray(result["env_costs"])
    comp_time = np.asarray(result["computation_time"])
    S, A = states.shape[1], actions.shape[1]

    fig = fig or plt.figure(figsize=figsize)
    axes = fig.subplots(nrows=S + A + 2)
    for i in range(S):
        axes[i].plot(states[:, i], label=f"$x_{i}$", color="tab:orange", marker="o", ms=2)
        axes[i].set_xlabel("Time step")
        axes[i].set_ylabel("State")
    for j in range(A):
        ax = axes[S + j]
        ax.plot(actions[:, j], label=f"$u_{j}$", color="tab:green", marker="o", ms=2)
        ax.set_xlabel("Time step")
        ax.set_ylabel("Action")
    axes[-2].plot(costs, label="costs")
    axes[-2].axhline(0.0, color="tab:red", linestyle=(0, (5, 10)))
    axes[-2].set_ylabel("Cost")
    axes[-2].set_title(f"Total Cost: {costs.sum():.4g}")
    axes[-1].plot(comp_time, label="Computation Time (s)", marker="h", ms=2)
    axes[-1].set_ylabel("Solve time (s)")
    axes[-1].grid(True)

    if plot_planning and "agent_planning_states" in result:
        # plans are stored densely: step i's plan starts at step i
        mpc_xs = np.asarray(result["agent_planning_states"])  # (N, T+1, S)
        mpc_us = np.asarray(result["agent_planning_actions"])  # (N, T, A)
        for i0 in range(mpc_xs.shape[0]):
            rng_x = range(i0, i0 + mpc_xs.shape[1])
            for i in range(S):
                axes[i].plot(rng_x, mpc_xs[i0, :, i], alpha=0.5,
                             linestyle=(0, (1, 1, 4, 1)), zorder=-1)
            rng_u = range(i0, i0 + mpc_us.shape[1])
            for j in range(A):
                axes[S + j].plot(rng_u, mpc_us[i0, :, j], alpha=0.5,
                                 linestyle=(0, (1, 1, 4, 1)), zorder=-1)

    for ax in axes:
        ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    return fig


def plot_experiments(results: List[Dict], figsize=(14, 14)):
    """Multi-solver comparison on shared axes (``Plot.py:86-135``)."""
    states0, actions0 = _dims(results[0])
    S, A = states0.shape[1], actions0.shape[1]
    fig = plt.figure(figsize=figsize)
    axes = fig.subplots(nrows=S + A + 2)
    for result in results:
        states, actions = _dims(result)
        label = result.get("agent_name", "agent")
        for i in range(S):
            axes[i].plot(states[:, i], label=f"{label} $x_{i}$", marker="o", ms=2)
        for j in range(A):
            axes[S + j].plot(actions[:, j], label=f"{label} $u_{j}$", marker="o", ms=2)
        axes[-2].plot(np.asarray(result["env_costs"]), label=label)
        axes[-1].plot(np.asarray(result["computation_time"]), label=label, marker="h", ms=2)
    for i in range(S):
        axes[i].set_ylabel("State")
    for j in range(A):
        axes[S + j].set_ylabel("Action")
    axes[-2].set_ylabel("Cost")
    axes[-1].set_ylabel("Solve time (s)")
    axes[-1].grid(True)
    for ax in axes:
        ax.legend(loc="upper left", fontsize=7)
    fig.tight_layout()
    return fig


def plot_cost_bands(
    grouped: Dict[str, np.ndarray], xlabel: str, ylabel: str = "total cost", figsize=(8, 5)
):
    """Median + quartile bands across a sweep axis — the summary-plot style
    of the sweep scripts (``scripts/sample_test.py`` mean±band plots)."""
    fig, ax = plt.subplots(figsize=figsize)
    for label, arr in grouped.items():
        xs = np.arange(len(arr["x"]))
        med = np.asarray(arr["median"])
        lo = np.asarray(arr["q25"])
        hi = np.asarray(arr["q75"])
        ax.plot(arr["x"], med, marker="o", label=label)
        ax.fill_between(arr["x"], lo, hi, alpha=0.2)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    return fig


def plot_ilqr_line_search(solver, state, x, g_z, out_dir, step_iteration: int = 0):
    """iLQR line-search debug plots: one figure per (outer iteration, α)
    with the pre-line-search trajectory, the current best and the candidate
    forward pass per state dimension, and the action rows with the old and
    new cost in the title. Runs the outer loop on the host, stage by stage
    (``ILQR.derivatives``, ``backward_pass`` or ``backward_pass_ref``, and
    ``forward_pass`` one α at a time, on a batch of one) so that every
    candidate is observable, with the reference's accept/convergence replay
    and μ/δ schedule. ``state.planned_us`` (T, A), x (S,), g_z (T, Z).
    Returns the written file paths."""
    import os

    import torch

    from ..ops.rollout import simulate_trajectory

    model = solver.model
    S, A = model.state_size, model.action_size
    os.makedirs(out_dir, exist_ok=True)
    lo = np.asarray(model.bounds_low, np.float32)
    hi = np.asarray(model.bounds_high, np.float32)
    alphas = solver.alphas(x.device)
    written = []

    x0 = x[None]
    us = state.planned_us[None]  # a batch of one
    mu, delta = 1.0, solver.delta_zero
    converged = False
    for it in range(solver.max_iter):
        mu = float(np.clip(mu, solver.mu_min, solver.mu_max))
        xs, cost = simulate_trajectory(model, x0, us, g_z)
        d = solver.derivatives(xs, us, g_z, ref_terminal=solver.diag_hessian)
        mu_t = torch.full((1,), mu, dtype=torch.float32, device=x.device)
        if solver.diag_hessian:
            ks, Ks, ok = solver.backward_pass_ref(d, mu_t)
        else:
            ks, Ks, ok = solver.backward_pass(d, mu_t)
        if not bool(ok[0]):
            delta = max(solver.delta_zero, delta * solver.delta_zero)
            mu = max(solver.mu_min, mu * delta)
            continue
        us = model.clip_action(us)
        test_us, test_xs = us, xs
        cost = float(cost[0])
        accepted = False
        for j in range(alphas.shape[0]):
            alpha = float(alphas[j])
            new_xs, new_us, new_cost = solver.forward_pass(alphas[j:j + 1], ks, Ks, test_xs,
                                                           test_us, g_z)
            new_xs, new_us, new_cost = new_xs[0], new_us[0], float(new_cost[0, 0])

            fig = plt.figure(figsize=(16, 10))
            ax = fig.subplots(nrows=S + A)
            ax[0].set_title(f"Timestep:{step_iteration}  Iteration:{it}  "
                            f"Mu:{mu:g} Alpha:{alpha:g}")
            for i in range(S):
                ax[i].plot(test_xs[0, :, i].cpu().numpy(), alpha=0.4, label=f"org_xs_{i}")
                ax[i].plot(xs[0, :, i].cpu().numpy(), label=f"x_{i}")
                ax[i].plot(new_xs[0, :, i].cpu().numpy(), linestyle="--",
                           label=f"x_hat_forward{i}")
                ax[i].legend(loc="upper left")
            ax[1].set_title(f"Old Cost: {cost} Cost_Hat: {new_cost}")
            for i in range(A):
                axi = ax[S + i]
                axi.plot(test_us[0, :, i].cpu().numpy(), alpha=0.4, label="org_u")
                axi.plot(us[0, :, i].cpu().numpy(), label=f"u_{i}")
                axi.plot(new_us[0, :, i].cpu().numpy(), linestyle="--",
                         label=f"u_hat_forward_{i}")
                axi.set_ylim(float(lo[i]) * 1.1, float(hi[i]) * 1.1)
                axi.legend(loc="upper left")
            path = os.path.join(out_dir,
                                f"step_{step_iteration}_iter_{it}_alpha_{j}_state_action.png")
            fig.savefig(path)
            plt.close(fig)
            written.append(path)

            if new_cost < cost:
                cost = new_cost
                xs, us = new_xs, new_us
                delta = min(1 / solver.delta_zero, delta / solver.delta_zero)
                mu = 0.0 if mu * delta < solver.mu_min else mu * delta
                accepted = True
            if cost != 0 and abs((cost - new_cost) / cost) < solver.threshold:
                converged = True
                break
        if not accepted:
            delta = max(solver.delta_zero, delta * solver.delta_zero)
            mu = max(solver.mu_min, mu * delta)
        if converged:
            break
    return written
