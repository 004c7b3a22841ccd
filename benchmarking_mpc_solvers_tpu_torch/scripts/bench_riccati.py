"""Sequential against parallel-in-horizon Riccati, at horizons T in {50,
100, 500} (configurations 3 and 4 run T=100).

Counterpart of ``scripts/bench_riccati.py``, with its benches and record
keys:

1. the TV-LQR backward pass: ``ops/riccati.py:tvlqr_backward`` (a loop over
   the horizon) against ``tvlqr_backward_assoc`` (an associative scan,
   O(log T) levels);
2. the box-QP solve of configuration 2's path: ``ops/qp.py:
   admm_solve_riccati_batch`` with ``parallel_horizon`` False and True, at
   B in {1, 256}, 50 ADMM iterations.

Each time is ``utils.slope_timer``'s (chains of 1 and n calls, fresh inputs
from a generator each call; n is 50 for the backward pass and 15 for the
solve, or ``--reps``, each chain timed ``--outer`` times). Prints one JSON
line per (bench, T, B) with µs per call and the parallel form's speedup
(>1: the scan wins), and writes them to
``<results-dir>/measure/bench_riccati.json``. The package keeps the
reference's ``parallel_horizon`` defaults whatever this reads.
"""

from __future__ import annotations

import json

import torch

from ..device import resolve_device
from ..ops.linearize import AffineDynamics, QuadCost
from ..ops.qp import admm_solve_riccati_batch
from ..ops.riccati import tvlqr_backward, tvlqr_backward_assoc
from ..utils import slope_timer
from ._common import device_record, std_parser, write_measure


def double_integrator(T, device, dt=0.02):
    A = torch.tensor([[1.0, dt], [0.0, 1.0]], device=device)
    B = torch.tensor([[0.0], [dt]], device=device)
    dyn = AffineDynamics(A.expand(T, 2, 2), B.expand(T, 2, 1), torch.zeros((T, 2), device=device))
    Q = torch.diag(torch.tensor([1.0, 0.1], device=device))
    R = torch.tensor([[0.1]], device=device)
    return dyn, Q, R, Q


def cost_for(T, Q, R, Qf, q, r):
    """The bench's stage costs with the linear terms q (T, 2), r (T, 1)."""
    dev = Q.device
    return QuadCost(Q=(2 * Q).expand(T, 2, 2), R=(2 * R).expand(T, 1, 1),
                    M=torch.zeros((T, 1, 2), device=dev), q=q, r=r, Qf=2 * Qf,
                    qf=torch.zeros(2, device=dev))


def timed(fn, inner, device, outer=3):
    per = slope_timer(fn, inner_reps=inner, outer_reps=outer, device=device)
    return per if per > 1e-7 else None


def _line(rec):
    print(json.dumps(rec), flush=True)
    return rec


def _speedup(t_seq, t_par):
    return round(t_seq / t_par, 2) if t_seq and t_par else None


def _us(t):
    return None if t is None else round(t * 1e6, 1)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    horizons = [5, 10] if q else [50, 100, 500]
    lines = []
    for T in horizons:
        dyn, Q, R, Qf = double_integrator(T, device)

        def fresh_cost(g):  # key-dependent linear terms: no call repeats another
            return cost_for(T, Q, R, Qf, 0.1 * torch.randn((T, 2), generator=g, device=device),
                            0.1 * torch.randn((T, 1), generator=g, device=device))

        reps = args.reps or (3 if q else 50)
        t_seq = timed(lambda g: tvlqr_backward(dyn, fresh_cost(g)).k.sum(), reps, device,
                      args.outer)
        t_par = timed(lambda g: tvlqr_backward_assoc(dyn, fresh_cost(g)).k.sum(), reps, device,
                      args.outer)
        lines.append(_line({"bench": "tvlqr_backward", "T": T, "seq_us": _us(t_seq),
                            "assoc_us": _us(t_par), "parallel_speedup": _speedup(t_seq, t_par)}))

        for B in ([1, 4] if q else [1, 256]):
            def solve(g, par, B=B):
                x0s = torch.randn((B, 2), generator=g, device=device)
                us, _, _, _ = admm_solve_riccati_batch(
                    dyn, x0s, Q, R, Qf, torch.zeros(2, device=device),
                    torch.zeros(1, device=device), -1.0, 1.0, iters=5 if q else 50, eps=0.0,
                    parallel_horizon=par)
                return us.sum()

            reps = args.reps or (2 if q else 15)
            t_seq = timed(lambda g: solve(g, False), reps, device, args.outer)
            t_par = timed(lambda g: solve(g, True), reps, device, args.outer)
            lines.append(_line({"bench": "admm_solve_riccati_batch", "T": T, "B": B,
                                "seq_us": _us(t_seq), "assoc_us": _us(t_par),
                                "parallel_speedup": _speedup(t_seq, t_par)}))
    return {"device": device_record(device), "lines": lines}


def main(argv=None) -> dict:
    p = std_parser(__doc__)
    p.add_argument("--reps", type=int, default=None, help="calls in the long chain")
    p.add_argument("--outer", type=int, default=3, help="times each chain is timed")
    args = p.parse_args(argv)
    out = run(args)
    write_measure(args, "bench_riccati", out)
    return out


if __name__ == "__main__":
    main()
