"""Sample-sharded MPPI: the K rollout samples of a batched MPPI step spread
over a ``sample`` mesh axis, the scenario batch over the ``batch`` axis.

Counterpart of ``benchmarking_mpc_solvers_tpu/parallel/mppi_sharded.py``.
Each device evaluates K/n_sample rollouts of its scenarios, then

    beta   = min over all samples of the cost     (global baseline)
    eta    = sum over all samples of exp(-(c-beta)/lam)
    update = sum over all samples of w_k * delta_k, w = exp(...)/eta

The reference takes these with ``pmin``/``psum`` over the sample axis. Within
one process the "collectives" are reductions of the shards' partial results,
gathered on the device of the batch shard's first sample shard, with beta
sent back to every shard before its weights are formed.
"""

from __future__ import annotations

import torch

from ..ops.rollout import rollout_cost_samples
from .mesh import BATCH_AXIS, SAMPLE_AXIS, Mesh, _on


def make_sharded_mppi_step(solver, mesh: Mesh):
    """Return ``step(planned_us, xs, generator=None, noise=None) ->
    (new_planned_us, u0s)``: planned_us (B, T, A), xs (B, S) split over
    ``BATCH_AXIS`` and replicated over ``SAMPLE_AXIS``; results on the
    mesh's first device.

    Sample shard j of batch shard i draws its k_local = K / n_sample
    standard normals (B_i, k_local, T, A) from a generator on its device
    seeded with base_i + j, base_i drawn once per call from ``generator``
    (default: one on the mesh's first device seeded with 0), as the
    reference folds the sample index into each scenario's key. ``noise``
    (B, K, T, A), standard normals with sample shard j holding samples
    j·k_local to (j+1)·k_local - 1, replaces the draws. The deltas are
    ``solver.std`` times the normals."""
    model = solver.model
    n_sample = mesh.shape[SAMPLE_AXIS]
    if solver.K % n_sample:
        raise ValueError(f"K={solver.K} not divisible by sample axis {n_sample}")
    k_local = solver.K // n_sample
    order = (mesh.axis_names.index(BATCH_AXIS), mesh.axis_names.index(SAMPLE_AXIS))
    grid = mesh.devices.transpose(order)  # (n_batch, n_sample)
    n_batch = grid.shape[0]
    T, A = solver.T, model.action_size
    lo, hi = model.lo(), model.hi()

    def local_costs(planned, x, delta):
        """One shard's (B_i, k_local) costs: rollouts plus the control term."""
        samples = planned[:, None] + delta
        g_z = torch.zeros((T, model.goal_size), dtype=torch.float32, device=x.device)
        roll, _ = rollout_cost_samples(model, x[:, None], samples, g_z)
        return roll + solver.lam * torch.einsum("bkta,bkta->bk", samples, delta) / solver.std**2

    def step(planned_us, xs, generator=None, noise=None):
        B = xs.shape[0]
        if B % n_batch:
            raise ValueError(f"a batch of {B} does not split over {n_batch} batch shards")
        b_local = B // n_batch
        home = grid[0, 0]
        if noise is None:
            gen = generator if generator is not None else torch.Generator(
                device=home).manual_seed(0)
            base = torch.randint(0, 2**62, (n_batch,), generator=gen,
                                 device=gen.device).tolist()
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32)
            if tuple(noise.shape) != (B, solver.K, T, A):
                raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                                 f"{(B, solver.K, T, A)}")
        # every shard's rollouts first, on its own device
        parts = []  # parts[i][j] = (planned, delta, costs) of shard (i, j)
        for i in range(n_batch):
            rows = slice(i * b_local, (i + 1) * b_local)
            row = []
            for j in range(n_sample):
                d = grid[i, j]
                with _on(d):
                    planned = planned_us[rows].to(d)
                    if noise is None:
                        g = torch.Generator(device=d).manual_seed(base[i] + j)
                        z = torch.randn((b_local, k_local, T, A), generator=g, device=d)
                    else:
                        z = noise[rows, j * k_local:(j + 1) * k_local].to(d)
                    delta = solver.std * z
                    row.append((planned, delta, local_costs(planned, xs[rows].to(d), delta)))
            parts.append(row)
        # the reductions over the sample axis, gathered on each batch shard's home
        new_planned = []
        for i, row in enumerate(parts):
            d0 = grid[i, 0]
            beta = torch.stack([c.min(dim=1).values.to(d0) for _, _, c in row]).min(dim=0).values
            expw = [torch.exp(-(c - beta.to(c.device)[:, None]) / solver.lam) for _, _, c in row]
            eta = torch.stack([e.sum(dim=1).to(d0) for e in expw]).sum(dim=0)
            update = torch.stack([
                torch.einsum("bk,bkta->bta", e / eta.to(e.device)[:, None], delta).to(d0)
                for e, (_, delta, _) in zip(expw, row)]).sum(dim=0)
            new_planned.append(row[0][0] + update)
        new_planned = torch.cat([p.to(home) for p in new_planned])
        u0s = torch.clamp(new_planned[:, 0], lo.to(home), hi.to(home))
        return new_planned, u0s

    return step
