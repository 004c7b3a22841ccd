"""Model diagnostics: print each model's transform, costs and dynamics at an
interior point, and check their derivatives (``torch.func``, the stack the
iLQR and SQP solvers rely on) against central finite differences.

Counterpart of ``scripts/difftools.py``.

Usage: python -m benchmarking_mpc_solvers_tpu_torch.scripts.difftools [--eps 1e-3] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch.func import grad, jacrev

from ..device import resolve_device
from ..models import AcrobotModel, CartPoleSwingUpModel, DummyModel, PendulumModel

MODELS = [PendulumModel, CartPoleSwingUpModel, AcrobotModel, DummyModel]


def central_diff(f, x, eps, device):
    """Central-difference Jacobian of f at x (columns over x's entries),
    each evaluation in float32 on the device, the differences in float64."""
    x = np.asarray(x, np.float64)
    cols = []
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = eps
        hi = f(torch.as_tensor(x + e, dtype=torch.float32, device=device))
        lo = f(torch.as_tensor(x - e, dtype=torch.float32, device=device))
        cols.append((hi.double().cpu().numpy() - lo.double().cpu().numpy()) / (2 * eps))
    return np.stack(cols, axis=-1)


def check(name, analytic, numeric, tol):
    err = float(np.max(np.abs(analytic.double().cpu().numpy() - numeric)))
    status = "OK " if err < tol else "FAIL"
    print(f"    {status} {name:22s} max|Δ| = {err:.3e}")
    return err < tol


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--tol", type=float, default=5e-2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    all_ok = True
    for model in MODELS:
        rng = np.random.default_rng(0)
        # an interior point away from clips and wraps, so that finite
        # differences are clean
        x = torch.as_tensor(0.3 * rng.standard_normal(model.state_size), dtype=torch.float32,
                            device=dev)
        u = torch.as_tensor(0.3 * rng.standard_normal(model.action_size), dtype=torch.float32,
                            device=dev)
        g_z = torch.zeros((model.goal_size,), dtype=torch.float32, device=dev)

        def show(t):
            return t.cpu().numpy()

        print(f"model {model.name}: state_size={model.state_size} "
              f"action_size={model.action_size} bounds={model.bounds_low}..{model.bounds_high}")
        print(f"  x          = {show(x)}")
        print(f"  u          = {show(u)}")
        print(f"  z(x,u)     = {show(model.transform(x, u))}")
        print(f"  cost       = {float(model.cost(x, u, g_z)):.6f}")
        print(f"  final_cost = {float(model.final_cost(x, g_z)):.6f}")
        print(f"  x_next     = {show(model.dynamics(x, u))}")

        print("  autodiff vs central differences:")
        all_ok &= check("df/dx", jacrev(model.dynamics, argnums=0)(x, u),
                        central_diff(lambda xx: model.dynamics(xx, u), x.cpu(), args.eps, dev),
                        args.tol)
        all_ok &= check("df/du", jacrev(model.dynamics, argnums=1)(x, u),
                        central_diff(lambda uu: model.dynamics(x, uu), u.cpu(), args.eps, dev),
                        args.tol)
        all_ok &= check("dc/dx", grad(lambda xx: model.cost(xx, u, g_z))(x),
                        central_diff(lambda xx: model.cost(xx, u, g_z), x.cpu(), args.eps, dev),
                        args.tol)
        all_ok &= check("dc/du", grad(lambda uu: model.cost(x, uu, g_z))(u),
                        central_diff(lambda uu: model.cost(x, uu, g_z), u.cpu(), args.eps, dev),
                        args.tol)
        print()

    if not all_ok:
        sys.exit("derivative check FAILED")
    print("all derivative checks passed")


if __name__ == "__main__":
    main()
