"""Per-configuration figure set: the reference's full ResultPlots surface.

Counterpart of ``scripts/per_config_plots.py``, with its figure layout
(under ``--plots-dir``, default ``ResultPlots_torch``):
  mppi_samples/<Env>/<T>_<K>_mppi.png
  mppi_samples/<Env>/combined<T>_mppi.png
  mppi_samples/<Env>_mppi_summary.png
  cem_ratio/<Env>/<T>_<K>_cem_r<ratio>.png
  cem_ratio/<Env>/combined<T>_<K>_cem.png
  cem_ratio/<Env>_<T>_cem_summary.png
  cem_ratio/Final_<Env>_cem_summary.png
and the families of mppi_temperature, ilqr_iterations and noise_test. It
reads the stores under ``--results-dir`` (default ``results_torch``; the JAX
package's ``results/`` is read the same way and never written).

Each per-config figure: one row per state dim and action dim (every
stored run's trajectory plus their mean) and a final per-step cost row
(median + IQR band over all repetitions, costs clipped to [0, 20] like
the reference's ``np.clip(costs, 0, 20)``). matplotlib is imported when the
first figure is drawn (the card's machine has none).
"""

import pathlib

import numpy as np

from ..experiment import ResultStore
from ._common import ENV_NAMES, std_parser


def _plt():
    """matplotlib.pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

ALPHA = 0.2
DPI = 60


def _pull(results):
    """states/actions trajectories + pooled per-step costs of matching rows."""
    states = [np.asarray(r["env_states"]) for r in results]
    actions = [np.asarray(r["env_actions"]) for r in results]
    costs = np.concatenate([
        np.asarray(r.get("batch_costs", r["env_costs"][None])) for r in results
    ], axis=0)
    return states, actions, np.clip(costs, 0, 20)


def _traj_axes(fig, states, actions, costs, label):
    S = states[0].shape[1]
    A = actions[0].shape[1]
    axs = fig.subplots(nrows=S + A + 1)
    t = np.arange(states[0].shape[0])
    for i in range(S):
        for tr in states:
            axs[i].plot(t, tr[:, i], alpha=ALPHA, color="C0")
        axs[i].plot(t, np.mean(states, axis=0)[:, i], color="C0", label=label)
        axs[i].set_ylabel(f"x_{i}")
    for i in range(A):
        for tr in actions:
            axs[S + i].plot(t, tr[:, i], alpha=ALPHA, color="C1")
        axs[S + i].plot(t, np.mean(actions, axis=0)[:, i], color="C1")
        axs[S + i].set_ylabel(f"u_{i}")
    axs[-1].fill_between(t, np.quantile(costs, 0.25, axis=0),
                         np.quantile(costs, 0.75, axis=0), alpha=ALPHA)
    axs[-1].plot(t, np.median(costs, axis=0), label=label)
    axs[-1].set_ylabel("Costs")
    axs[-1].set_xlabel("Time - t")
    return axs


def _overlay(axs, states, actions, costs, label):
    S = states[0].shape[1]
    A = actions[0].shape[1]
    t = np.arange(states[0].shape[0])
    sm, ss = np.mean(states, axis=0), np.std(states, axis=0)
    am, asd = np.mean(actions, axis=0), np.std(actions, axis=0)
    for i in range(S):
        axs[i].fill_between(t, sm[:, i] - 2 * ss[:, i], sm[:, i] + 2 * ss[:, i],
                            alpha=ALPHA)
        axs[i].plot(t, sm[:, i], label=label)
        axs[i].set_ylabel(f"x_{i}")
    for i in range(A):
        axs[S + i].fill_between(t, am[:, i] - 2 * asd[:, i],
                                am[:, i] + 2 * asd[:, i], alpha=ALPHA)
        axs[S + i].plot(t, am[:, i], label=label)
        axs[S + i].set_ylabel(f"u_{i}")
    axs[-1].fill_between(t, np.quantile(costs, 0.25, axis=0),
                         np.quantile(costs, 0.75, axis=0), alpha=ALPHA)
    axs[-1].plot(t, np.median(costs, axis=0), label=label)
    axs[-1].set_ylabel("Costs")
    axs[-1].set_xlabel("Time - t")


def _summary(ax, xs, series, xlabel):
    """series: {label: (medians, q25s, q75s) indexed like xs}."""
    for label, (med, q25, q75) in series.items():
        ax.plot(xs, med, label=label)
        ax.fill_between(xs, q25, q75, alpha=ALPHA)
    ax.set_xticks(xs)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Performance Cost")
    ax.legend(loc="upper left")
    ax.grid()


def mppi_figs(store, plots_dir, env_name, Ts, Ks):
    envdir = plots_dir / "mppi_samples" / env_name
    envdir.mkdir(parents=True, exist_ok=True)
    n = 0
    per_T = {}
    for T in Ts:
        fig_c = _plt().figure(figsize=(10, 8))
        axs_c = None
        K_stats = {}
        for K in Ks:
            results = store.find({"env_name": env_name, "agent_config.T": T,
                                  "agent_config.K": K,
                                  "actuation_noise": False,
                                  "sensor_noise": False})
            if not results:
                continue
            states, actions, costs = _pull(results)
            fig = _plt().figure(figsize=(10, 8))
            _traj_axes(fig, states, actions, costs, f"K={K}")
            fig.suptitle(f"MPPI {env_name} T:{T} K:{K}")
            fig.tight_layout()
            fig.savefig(envdir / f"{T}_{K}_mppi.png", dpi=DPI)
            _plt().close(fig)
            n += 1
            if axs_c is None:
                S = states[0].shape[1]
                A = actions[0].shape[1]
                axs_c = fig_c.subplots(nrows=S + A + 1)
            _overlay(axs_c, states, actions, costs, f"K={K}")
            tot = costs.sum(axis=1)
            K_stats[K] = (np.median(tot), np.quantile(tot, 0.25),
                          np.quantile(tot, 0.75))
        if axs_c is not None:
            for ax in axs_c:
                ax.legend(loc="upper left", fontsize=6)
            fig_c.suptitle(f"MPPI {env_name} T:{T}")
            fig_c.tight_layout()
            fig_c.savefig(envdir / f"combined{T}_mppi.png", dpi=DPI)
            n += 1
        _plt().close(fig_c)
        if K_stats:
            per_T[T] = K_stats
    if per_T:
        fig = _plt().figure(figsize=(8, 6))
        ax = fig.add_subplot()
        Ks_all = sorted({k for d in per_T.values() for k in d})
        series = {}
        for T, d in per_T.items():
            # NaN-pad to the union x-axis: a T missing one cell must not
            # crash the whole figure run with a length mismatch
            series[f"T={T}"] = tuple(
                [d[k][j] if k in d else np.nan for k in Ks_all]
                for j in range(3)
            )
        _summary(ax, Ks_all, series, "Sample Amount - K")
        fig.suptitle(f"MPPI Samples Summary {env_name}")
        fig.savefig(plots_dir / "mppi_samples" / f"{env_name}_mppi_summary.png",
                    dpi=DPI)
        _plt().close(fig)
        n += 1
    return n


def cem_figs(store, plots_dir, env_name, Ts, Ks, ratios):
    envdir = plots_dir / "cem_ratio" / env_name
    envdir.mkdir(parents=True, exist_ok=True)
    n = 0
    T_perf = []  # [T][K][ratio] -> (med, q25, q75)
    for T in Ts:
        K_perf = []
        for K in Ks:
            fig_c = _plt().figure(figsize=(10, 8))
            axs_c = None
            r_perf = []
            for ratio in ratios:
                results = store.find({
                    "env_name": env_name, "agent_config.T": T,
                    "agent_config.K": K, "agent_config.elite_ratio": ratio,
                    "actuation_noise": False, "sensor_noise": False})
                if not results:
                    r_perf.append((np.nan, np.nan, np.nan))
                    continue
                states, actions, costs = _pull(results)
                rtag = str(ratio).replace(".", "_")
                fig = _plt().figure(figsize=(10, 8))
                _traj_axes(fig, states, actions, costs, f"r={ratio}")
                fig.suptitle(f"CEM Ratio {env_name} T:{T} K:{K} r:{ratio}")
                fig.tight_layout()
                fig.savefig(envdir / f"{T}_{K}_cem_r{rtag}.png", dpi=DPI)
                _plt().close(fig)
                n += 1
                if axs_c is None:
                    S = states[0].shape[1]
                    A = actions[0].shape[1]
                    axs_c = fig_c.subplots(nrows=S + A + 1)
                _overlay(axs_c, states, actions, costs, f"r={ratio}")
                tot = costs.sum(axis=1)
                r_perf.append((np.median(tot), np.quantile(tot, 0.25),
                               np.quantile(tot, 0.75)))
            if axs_c is not None:
                for ax in axs_c:
                    ax.legend(loc="upper left", fontsize=6)
                fig_c.suptitle(f"Cem Ratios {env_name} T:{T} K:{K}")
                fig_c.tight_layout()
                fig_c.savefig(envdir / f"combined{T}_{K}_cem.png", dpi=DPI)
                n += 1
            _plt().close(fig_c)
            K_perf.append(r_perf)
        T_perf.append(K_perf)
        # per-T summary: cost vs K, one line per ratio
        arr = np.asarray(K_perf)  # (K, ratio, 3)
        if np.isfinite(arr).any():
            fig = _plt().figure(figsize=(8, 6))
            ax = fig.add_subplot()
            series = {
                f" r={ratios[i]}": (arr[:, i, 0], arr[:, i, 1], arr[:, i, 2])
                for i in range(len(ratios))
            }
            _summary(ax, Ks, series, "Sample Amount - K")
            fig.suptitle(f"CEM Ratio Summary {env_name} for T:{T}")
            fig.savefig(plots_dir / "cem_ratio" / f"{env_name}_{T}_cem_summary.png",
                        dpi=DPI)
            _plt().close(fig)
            n += 1
    # final summary averaged over T (reference's Final_*_cem_summary.png;
    # it plots len(ratios)-1 lines — we plot all ratios)
    arr = np.asarray(T_perf)  # (T, K, ratio, 3)
    if np.isfinite(arr).any():
        m = np.nanmean(arr, axis=0)  # (K, ratio, 3)
        fig = _plt().figure(figsize=(8, 6))
        ax = fig.add_subplot()
        series = {
            f" r={ratios[i]}": (m[:, i, 0], m[:, i, 1], m[:, i, 2])
            for i in range(len(ratios))
        }
        _summary(ax, Ks, series, "Sample Amount - K")
        fig.suptitle(f"CEM Ratios Summary {env_name} averaged over Horizon Length")
        fig.savefig(plots_dir / "cem_ratio" / f"Final_{env_name}_cem_summary.png",
                    dpi=DPI)
        _plt().close(fig)
        n += 1
    return n


def main(argv=None) -> int:
    args = std_parser(__doc__).parse_args(argv)
    plots_dir = pathlib.Path(args.plots_dir)
    mppi_store = ResultStore(args.results_dir, "mppi_samples")
    cem_store = ResultStore(args.results_dir, "cem_ratios")
    Ts = [5] if args.quick else [5, 10, 25, 50]
    Ks_mppi = [8, 16] if args.quick else [10, 20, 50, 100, 200, 500]
    Ks_cem = [8] if args.quick else [10, 20, 50, 100, 200]
    ratios = [0.25, 0.5] if args.quick else [0.1, 0.25, 0.5, 0.75, 1.0]
    temp_store = ResultStore(args.results_dir, "temperature_exp")
    ilqr_store = ResultStore(args.results_dir, "ilqr_runs2")
    noise_store = ResultStore(args.results_dir, "noise_test")
    lams = [0.1] if args.quick else [0.001, 0.01, 0.1, 0.5, 1.0, 10.0]
    iters = [2] if args.quick else [5, 10, 25]
    sigmas = [0.0, 0.5] if args.quick else [0.0, 0.1, 0.5, 1.0]
    total = 0
    for env_name in ENV_NAMES.values():
        total += mppi_figs(mppi_store, plots_dir, env_name, Ts, Ks_mppi)
        total += cem_figs(cem_store, plots_dir, env_name, Ts, Ks_cem, ratios)
        total += param_family(
            temp_store, plots_dir, "mppi_temperature", env_name, Ts,
            "lam", lams, "{T}_mppi_l{v}.png", "lam", "mppi_summary")
        total += param_family(
            ilqr_store, plots_dir, "ilqr_iterations", env_name, Ts,
            "max_iter", iters, "{T}_ilqr_m{v}.png", "max_iter",
            "ilqr_summary")
        total += noise_figs(noise_store, plots_dir, env_name,
                            ["CEM", "MPPI", "ILQR", "I2C"], sigmas)
        print(f"{env_name}: cumulative {total} figures", flush=True)
    print(f"wrote {total} figures under {plots_dir}/mppi_samples and "
          f"{plots_dir}/cem_ratio")
    return total




# --- the remaining reference figure families (same trajectory-figure
# layout): mppi_temperature/<Env>/<T>_mppi_l<lam>.png,
# ilqr_iterations/<Env>/<T>_ilqr_m<iter>.png, and
# noise_test/<Env>/{actuation,sensor}_noise/<AGENT>_averaged_n<sig>.png
# (reference: scripts/mppi_temperature.py / ilqr_tuning.py /
# noise_tests.py generate_plots) -------------------------------------------


def _tag(v):
    return str(v).rstrip("0").rstrip(".") if isinstance(v, float) else str(v)


def param_family(store, plots_dir, family, env_name, Ts, param_key, values,
                 fname_fmt, label_prefix, summary_name, extra_query=None):
    """Per-(T, param) trajectory figures + per-T combined overlays + a
    per-env summary (cost vs param, one line per T)."""
    envdir = plots_dir / family / env_name
    envdir.mkdir(parents=True, exist_ok=True)
    n = 0
    per_T = {}
    for T in Ts:
        fig_c = _plt().figure(figsize=(10, 8))
        axs_c = None
        stats = {}
        for v in values:
            q = {"env_name": env_name, "agent_config.T": T,
                 f"agent_config.{param_key}": v,
                 "actuation_noise": False, "sensor_noise": False}
            q.update(extra_query or {})
            results = store.find(q)
            if not results:
                continue
            states, actions, costs = _pull(results)
            fig = _plt().figure(figsize=(10, 8))
            _traj_axes(fig, states, actions, costs,
                       f"{label_prefix}={v}")
            fig.suptitle(f"{env_name} T:{T} {label_prefix}:{v}")
            fig.tight_layout()
            fig.savefig(envdir / fname_fmt.format(T=T, v=_tag(v).replace(".", "_")),
                        dpi=DPI)
            _plt().close(fig)
            n += 1
            if axs_c is None:
                S = states[0].shape[1]
                A = actions[0].shape[1]
                axs_c = fig_c.subplots(nrows=S + A + 1)
            _overlay(axs_c, states, actions, costs, f"{label_prefix}={v}")
            tot = costs.sum(axis=1)
            stats[v] = (np.median(tot), np.quantile(tot, 0.25),
                        np.quantile(tot, 0.75))
        if axs_c is not None:
            for ax in axs_c:
                ax.legend(loc="upper left", fontsize=6)
            fig_c.suptitle(f"{env_name} T:{T}")
            fig_c.tight_layout()
            fig_c.savefig(envdir / f"combined{T}.png", dpi=DPI)
            n += 1
        _plt().close(fig_c)
        if stats:
            per_T[T] = stats
    if per_T:
        fig = _plt().figure(figsize=(8, 6))
        ax = fig.add_subplot()
        vals_all = sorted({v for d in per_T.values() for v in d})
        series = {}
        for T, d in per_T.items():
            # NaN-pad to the union x-axis (see mppi_figs)
            series[f"T={T}"] = tuple(
                [d[v][j] if v in d else np.nan for v in vals_all]
                for j in range(3)
            )
        _summary(ax, vals_all, series, label_prefix)
        ax.set_xscale("log" if all(
            isinstance(v, float) and v > 0 for v in vals_all) else "linear")
        fig.suptitle(f"{family} summary {env_name}")
        fig.savefig(plots_dir / family / f"{env_name}_{summary_name}.png",
                    dpi=DPI)
        _plt().close(fig)
        n += 1
    return n


def noise_figs(store, plots_dir, env_name, agents, sigmas):
    """noise_test/<Env>/{actuation,sensor}_noise/<AGENT>_averaged_n<sig>.png
    + per-agent summary (cost vs sigma for both modes)."""
    n = 0
    for mode, flag_key, std_key in (
        ("actuation", "actuation_noise", "actuation_noise_std"),
        ("sensor", "sensor_noise", "sensor_noise_std"),
    ):
        outdir = plots_dir / "noise_test" / env_name / f"{mode}_noise"
        outdir.mkdir(parents=True, exist_ok=True)
        for agent in agents:
            stats = {}
            for sig in sigmas:
                if sig == 0.0:
                    q = {"env_name": env_name, "agent_name": agent,
                         "actuation_noise": False, "sensor_noise": False}
                else:
                    q = {"env_name": env_name, "agent_name": agent,
                         flag_key: True, std_key: sig}
                results = store.find(q)
                if not results:
                    continue
                states, actions, costs = _pull(results)
                if sig > 0.0:
                    fig = _plt().figure(figsize=(10, 8))
                    _traj_axes(fig, states, actions, costs, f"σ={sig}")
                    fig.suptitle(f"{agent} {env_name} {mode} noise σ={sig}")
                    fig.tight_layout()
                    fig.savefig(
                        outdir / f"{agent}_averaged_n{_tag(sig).replace('.', '_')}.png",
                        dpi=DPI)
                    _plt().close(fig)
                    n += 1
                tot = costs.sum(axis=1)
                stats[sig] = (np.median(tot), np.quantile(tot, 0.25),
                              np.quantile(tot, 0.75))
            if stats:
                fig = _plt().figure(figsize=(8, 6))
                ax = fig.add_subplot()
                xs = sorted(stats)
                series = {agent: tuple([stats[s][j] for s in xs]
                                       for j in range(3))}
                _summary(ax, xs, series, f"{mode} noise σ")
                fig.suptitle(f"{agent} {env_name} {mode}-noise summary")
                fig.savefig(outdir / f"{agent}_summary.png", dpi=DPI)
                _plt().close(fig)
                n += 1
    return n


if __name__ == "__main__":
    main()
