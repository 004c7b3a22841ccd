"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, drive, time; one card
    python3 chip_smoke.py --ptxas    # the same, and each kernel's registers and spills

Phases (any failure exits non-zero before the result line):
1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every kernel from ``benchmarking_mpc_solvers_tpu_torch/
   csrc`` (one nvcc per source, in parallel).
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on each model, at the main paths' shapes (kernels 2, 3, 5, 6, 7,
   8a and 8b bit for bit, 1, 2, 3, 5, 6, 8a and 8b also at the edges of their
   lane groups, blocks and shared-memory stages; kernel 1 also at the
   sweep's MPPI row and in the form that redraws its noise, kernel 2 also at
   the CEM two-stage shape, kernel 7 at the edges of its three forms and
   past a block's shared memory, n up to 1,100).
4. main paths, each with the launch counters set to 0 just before its run
   and read just after:
   - MPPI, the bench configuration (cart-pole swing-up, K=32, T=50,
     B=8192, 20 MPC steps) on the kernel tier and the two-stage tier;
   - CEM, the sweep configuration (cart-pole swing-up, K=64, n_elite=8,
     max_iter=3, T=50, B=10240, 10 MPC steps) on both tiers;
   - iLQR, the batched configuration (cart-pole swing-up, T=100,
     max_iter=5, reference_accept=False, B=1024, warm start 10, 20 MPC
     steps) through the Riccati and line-search kernels, with exact
     Hessians and again with gauss_newton=True (then also the derivative
     kernel);
   - SQP, the suite's configuration 4 (acrobot, T=100, max_iter=4, B=1024,
     20 MPC steps from [0.1, 0, 0.2, 0]) through the derivative, Riccati
     and line-search kernels;
   - QP-MPC, the suite's configuration 1 (pendulum, T=20, condensed ADMM,
     100 iterations, B=512, 50 MPC steps) through the ADMM kernel, and
     configuration 2 (cart-pole stabilisation, T=50, Riccati-ADMM, 60
     iterations, B=256, 40 MPC steps), which is plain PyTorch;
   - I2C, the suite's configuration 6 (pendulum, T=25, max_iter=10, B=256,
     50 MPC steps) and its row of the six-family sweep (cart-pole
     swing-up, T=50, max_iter=3, B=10240, 10 MPC steps), each iteration
     through the Kalman-filter and RTS-smoother kernels;
   plus small MPPI, CEM, iLQR, SQP, QP-MPC and I2C episodes on the card
   against the plain versions on the CPU, and short swing-up progress
   checks.
5. timings with CUDA events: each kernel around one call and as device
   time (calls queued behind a sleeping kernel, ``device_time_ms``), its
   plain version and its bound (for kernels 5, 6, 7, 8a and 8b also with the
   dependent chain of the horizon or of the iterations; for kernels 1, 2
   and 3 also the instruction-issue floor of the rollout loop, counted in
   its SASS; the launch shape of 1, 2, 3, 6 and 7; kernels 1, 2 and 7 at
   further shapes too); host-clock
   episode solves/s of every path; device time by kernel under the
   profiler (one episode of each MPPI and CEM tier, one solve of iLQR, SQP,
   QP-MPC and I2C).
Then a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.

Imports only the port (``benchmarking_mpc_solvers_tpu_torch``), never JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HORIZON, K_SAMPLES, BATCH, N_STEPS = 50, 32, 8192, 20
# the MPPI row of the six-family sweep (scripts/bench_suite.py:257, cart-pole,
# T = 50), at which kernel 1 is also checked and timed
MPPI_SWEEP_K, MPPI_SWEEP_B = 64, 10240
# CEM sweep (scripts/bench_suite.py:256-266) and iLQR configuration 3
# (scripts/bench_suite.py:216-223) of the reference's suite
CEM_T, CEM_K, CEM_ELITE, CEM_ITERS, CEM_B, CEM_STEPS = 50, 64, 8, 3, 10240, 10
ILQR_T, ILQR_ITERS, ILQR_B, ILQR_WARM, ILQR_STEPS, N_ALPHAS = 100, 5, 1024, 10, 20, 10
# SQP configuration 4 and the QP-MPC configurations 1 and 2
# (scripts/bench_suite.py:225-238, :168-177, :179-214)
SQP_T, SQP_ITERS, SQP_B, SQP_STEPS, SQP_START = 100, 4, 1024, 20, (0.1, 0.0, 0.2, 0.0)
QP1_T, QP1_ITERS, QP1_B, QP1_STEPS = 20, 100, 512, 50
QP2_T, QP2_ITERS, QP2_B, QP2_STEPS, QP2_START = 50, 60, 256, 40, (0.3, 0.0, 0.4, 0.0)
# I2C configuration 6 and the I2C row of the six-family sweep
# (scripts/bench_suite.py:341-347, :251-264), starts jittered by 1e-3 as there
I2C6_T, I2C6_ITERS, I2C6_B, I2C6_STEPS = 25, 10, 256, 50
I2CS_T, I2CS_ITERS, I2CS_B, I2CS_STEPS = 50, 3, 10240, 10
QP2_WEIGHTS = dict(goal_x=(0.0, 0.0, 0.0, 0.0), R=((0.1,),),
                   Q=((0.5, 0, 0, 0), (0, 0.1, 0, 0), (0, 0, 5.0, 0), (0, 0, 0, 0.5)))

# Kernel-vs-plain tolerance. Both sides run float32 one IEEE operation at a
# time (the kernels are built with --fmad=false and accurate libm calls), so
# the rollouts agree to rounding; what differs is summation order (warp
# trees vs sequential sums) in the softmax and the plan update, ~1e-6
# relative. 1e-4 leaves room for a rollout that rounds differently near a
# branch of a clamp or floor-mod.
# The derivative kernel pushes forward-mode tangents through the model where
# its plain version differentiates in reverse mode: the same float32
# formulas in another order, a few ulps of the largest term of each sum,
# inside the same tolerance (the reference holds its kernel to 1e-5 at
# O(1) inputs). The ADMM kernel sums its matvec in the plain version's
# order and must match it bit for bit, as must the rollout-cost kernel,
# whose rollouts sum their steps in the plain version's order.
RTOL, ATOL = 1e-4, 1e-4
# Card vs CPU episodes of CEM and iLQR: the card's and the CPU's libm round
# sin/cos/log apart by an ulp; CEM's std = sqrt(m2 − m1²) of nearly equal
# elites turns that into up to 2.4e-4·|m1|, and a converged iLQR accept
# test (best < nominal within one ulp) can fall either way, a step of
# ~1e-3 (tests/test_torch_cem.py, tests/test_torch_ilqr.py).
CEM_EPISODE_TOL, ILQR_EPISODE_TOL = 1e-3, 2e-3
# SQP's accept test and argmin over alpha tie like iLQR's
# (tests/test_torch_sqp.py); QP-MPC's condensed H is factorized by another
# Cholesky routine on the card than on the CPU (tests/test_torch_qp_mpc.py)
SQP_EPISODE_TOL, QP_EPISODE_TOL = 2e-3, 1e-3
# I2C's smoother kernels match their plain versions bit for bit; around them
# the card's and the CPU's libm and matrix products round apart, and the
# line search compares three rollout costs (tests/test_torch_i2c.py)
I2C_EPISODE_TOL = 2e-3

# FP32 operations per rollout step, counted by hand from csrc/models.cuh
# (each add, mul, div, clamp compare and each libm call counted once, so
# the bound is a lower bound): transform + nonzero-W cost with its clip +
# dynamics + the running sum. Cart-pole: transform 8, cost 10, dynamics 40,
# sum 1.
STEP_OPS = {"pendulum": 34, "cartpole_swingup": 59, "acrobot": 252}
# the noise draw (u01 x2, +1e-7, log, -2*, sqrt, 2pi*, cos, r*), counted once
# per (b, k, t): the function needs one normal there. Where its cache does
# not fit, the kernel draws it a second time in pass 2; that is a cost of the
# design, not of the function, and is left out of the bound. MPPI extras
# per (b, k, t): pass 1 std*d, plan+sd, control term (3); pass 2 w*(std*d)
# and += (std*d is pass 1's). Per (b, k), the softmax: the min, c - beta,
# /lam, exp, the weight sum and w/sum, once per sample as the function
# needs them.
NOISE_OPS, PASS1_EXTRA, PASS2_EXTRA, MPPI_WEIGHT_OPS = 9, 5, 2, 6
# CEM, from csrc/fused_cem.cu: per (b, k, t, it) the sample mean+std*d and
# its clip (4); per (b, elite, t, it) the moments m1 += w*u, m2 += w*(u*u)
# (5); per (b, t, it) std_e = sqrt(max(m2 - m1*m1, 0)) and the two
# smoothings (10); per (b, k, round, it) the masked-min cost + sel*excl,
# the min and the tie test (4). The pass-2 redraw of the elites' noise is a
# cost of the design (it keeps no samples) and is left out.
CEM_SAMPLE_OPS, CEM_MOMENT_OPS, CEM_UPDATE_OPS, CEM_SELECT_OPS = 4, 5, 10, 4
# line search, from csrc/fused_linesearch.cu: per (a, b, t) the feedback
# sum_i K_i*(x_i - xref_i) (3S), us + alpha*ks + fb (3), the clip (2); the
# terminal cost, once per candidate, is left out (under 0.3 % of the ops)
LS_EXTRA = lambda S: 3 * S + 5  # noqa: E731
# ADMM, per row and iteration, as the function needs them: the matvec's n
# products and n - 1 adds (2n - 1), v = rho*(z-y)-g (3), u' (3), u' + y (1),
# the clip (2), y+ = (u' + y) - z+ (1, the sum before the clip reused)
ADMM_ROW_OPS = lambda n: 2 * n + 9  # noqa: E731
# kernel 7 at a problem of n > 240 (the streaming form), timed beside its
# shapes of the suite: the shared layout, as QP-MPC at linearize_at="goal"
ADMM_BIG_N, ADMM_BIG_B, ADMM_BIG_ITERS = 300, 512, 20
PEAK_FP32 = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s, published, at 700 W
# a dependent FP32 operation's latency in cycles, the least the card's
# pipeline takes (a square root or a division takes many more)
FP32_LATENCY_CYCLES = 4
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def riccati_ops(S: int) -> int:
    """FP32 operations of one Riccati step in csrc/riccati_backward.cu
    (without c): each sum of S products counts 2S, each added term 1."""
    sums = 2 * S
    return (S * (sums + 1)          # q_x
            + sums + 1              # q_u
            + S * S * sums          # m = V_xx f_x
            + S * S * (sums + 1)    # q_xx
            + S * sums + sums + 1   # V_xx f_u, q_uu
            + S * (sums + 1)        # q_ux
            + sums + 2              # fufu, q_uu_r
            + S * (sums + 2)        # q_ux_r
            + 3 + 2 + 2 * S         # pd test and inverse, k, K
            + 6 * S                 # V_x
            + 7 * S * S             # V_xx before symmetrising
            + 2 * S * S)            # symmetrising


def chol_ops(n: int) -> int:
    """FP32 operations of the unrolled n x n Cholesky factorisation in
    csrc/i2c_smooth.cu: entry (i, j) takes j multiply-subtracts and a square
    root or a division; each diagonal entry one more for its floor."""
    return sum(2 * j + 1 for i in range(n) for j in range(i + 1)) + n


def i2c_filter_ops(D: int, Z: int) -> int:
    """FP32 operations of one filter step in csrc/i2c_smooth.cu: each sum
    of n products counts 2n, each added term 1."""
    return (D * Z * 2 * D                       # P J^T
            + Z * (Z + 1) // 2 * (2 * D + 1)    # lower triangle of sig_y
            + chol_ops(Z)
            + D * 2 * Z * Z                     # D pairs of triangular solves
            + Z * (2 * D + 2)                   # innovation
            + D * (2 * Z + 1)                   # mu_f
            + D * D * (2 * Z + 1) + 2 * D * D   # sig_f and its symmetrising
            + D * (2 * D + 1)                   # mu_pred
            + D * D * 2 * D + D * D * (2 * D + 1))  # F sig_f, sig_pred


def i2c_rts_ops(D: int) -> int:
    """FP32 operations of one smoother step in csrc/i2c_smooth.cu."""
    return (D * D * 2 * D + chol_ops(D) + D * 2 * D * D   # F sig_f, factor, D solves
            + D + D * (2 * D + 1)                         # mu_s
            + D * D + D * D * 2 * D + D * D * (2 * D + 1))  # sig_s


def _dep(*depths):
    """Depth of one operation on operands of the given depths: one more
    than the deepest. None marks a value the chain does not wait for (an
    input of the step, which a kernel may load or compute ahead)."""
    known = [d for d in depths if d is not None]
    return max(known) + 1 if known else None


def _sum(terms):
    """A sum taken from 0 upwards, as the reference takes it (0 + t0 is an
    operation of its own)."""
    s = None
    for t in terms:
        s = _dep(s, t)
    return s


def _chol_depths(A, n):
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = _dep(s, _dep(L[i][k], L[j][k]))
            L[i][j] = _dep(_dep(s)) if i == j else _dep(s, L[j][j])  # floor, sqrt
    return L


def _solve_depths(L, b, n):
    y, x = [None] * n, [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = _dep(s, _dep(L[i][k], y[k]))
        y[i] = _dep(s, L[i][i])
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = _dep(s, _dep(L[k][i], x[k]))
        x[i] = _dep(s, L[i][i])
    return x


def _filter_step_depth(D, Z, sig, mu):
    """Deepest new carried value (predicted covariance and mean) of one
    filter step of csrc/i2c_smooth.cu, from carried depths sig and mu."""
    rd, rz = range(D), range(Z)
    sig_p, mu_p = [[sig] * D for _ in rd], [mu] * D
    PJt = [[_sum(_dep(sig_p[i][k], None) for k in rd) for _ in rz] for i in rd]
    sig_y = [[_dep(None, _sum(_dep(None, PJt[k][c]) for k in rd)) for c in rz] for _ in rz]
    Lc = _chol_depths(sig_y, Z)
    sols = [_solve_depths(Lc, PJt[i], Z) for i in rd]
    innov = [_dep(None, _dep(_sum(_dep(None, mu_p[k]) for k in rd), None)) for _ in rz]
    mu_f = [_dep(mu_p[i], _sum(_dep(sols[i][a], innov[a]) for a in rz)) for i in rd]
    sf = [[_dep(sig_p[i][j], _sum(_dep(sols[i][a], PJt[j][a]) for a in rz)) for j in rd]
          for i in rd]
    sig_f = [[_dep(_dep(sf[i][j], sf[j][i])) for j in rd] for i in rd]
    FS = [[_sum(_dep(None, sig_f[k][j]) for k in rd) for j in rd] for _ in rd]
    new = [_dep(_sum(_dep(FS[i][k], None) for k in rd), None) for i in rd for _ in rd]
    new += [_dep(None, _sum(_dep(None, mu_f[k]) for k in rd)) for _ in rd]
    return max((d for d in new if d is not None), default=0)


def i2c_filter_chain(D: int, Z: int) -> int:
    """Dependent FP32 operations of one filter step's loop-carried chain in
    csrc/i2c_smooth.cu: the longest path from one step's predicted
    covariance (or mean) to the next step's, every sum in the reference
    order, a square root, a division and the Cholesky floor each one
    operation. T of them in a row are a lower bound of the horizon's time."""
    return max(_filter_step_depth(D, Z, 0, None), _filter_step_depth(D, Z, None, 0))


def _rts_step_depth(D, sig, mu):
    rd = range(D)
    sig_next, mu_next = [[sig] * D for _ in rd], [mu] * D
    # G, its factor and M come from the step's inputs alone
    new = [_dep(None, _sum(_dep(None, _dep(mu_next[k], None)) for k in rd)) for _ in rd]
    Dlt = [[_dep(sig_next[i][j], None) for j in rd] for i in rd]
    GD = [[_sum(_dep(None, Dlt[k][j]) for k in rd) for j in rd] for _ in rd]
    new += [_dep(None, _sum(_dep(GD[i][k], None) for k in rd)) for i in rd for _ in rd]
    return max((d for d in new if d is not None), default=0)


def i2c_rts_chain(D: int) -> int:
    """The smoother's loop-carried chain per step, as ``i2c_filter_chain``:
    the gain G does not depend on the carry, so only sig_s and mu_s are on it."""
    return max(_rts_step_depth(D, 0, None), _rts_step_depth(D, None, 0))


def _riccati_step_depth(S, vxx, vx, with_c):
    """Deepest new carried value (V_xx or V_x) of one step of
    csrc/riccati_backward.cu, from carried depths vxx and vx; the step's
    inputs (f_x, f_u, l_*, c, mu) are off the chain."""
    rs = range(S)
    vxc = [_dep(vx, _sum(_dep(vxx, None) for _ in rs)) if with_c else vx for _ in rs]
    m = [[_sum(_dep(vxx, None) for _ in rs) for _ in rs] for _ in rs]
    w = [_sum(_dep(vxx, None) for _ in rs) for _ in rs]
    q_x = [_dep(None, _sum(_dep(None, vxc[i]) for i in rs)) for _ in rs]
    q_u = _dep(None, _sum(_dep(None, vxc[i]) for i in rs))
    q_xx = [[_dep(None, _sum(_dep(None, m[i][jp]) for i in rs)) for jp in rs] for _ in rs]
    q_uu = _dep(None, _sum(_dep(None, w[i]) for i in rs))
    q_ux = [_dep(None, _sum(_dep(None, m[i][j]) for i in rs)) for j in rs]
    inv = _dep(_dep(_dep(_dep(q_uu, None))))  # + mu*fufu, the PD test, its select, 1/x
    k = _dep(_dep(q_u), inv)
    K = [_dep(_dep(_dep(q_ux[j], None)), inv) for j in rs]  # + mu*(f_u f_x), -, * inv
    new = [_dep(_dep(q_x[j], _dep(K[j], _dep(_dep(q_uu, k), q_u))), _dep(q_ux[j], k))
           for j in rs]
    vnew = [[_dep(_dep(_dep(q_xx[j][jp], _dep(_dep(K[j], q_uu), K[jp])), _dep(K[j], q_ux[jp])),
                  _dep(q_ux[j], K[jp])) for jp in rs] for j in rs]
    new += [_dep(_dep(vnew[j][jp], vnew[jp][j])) for j in rs for jp in rs]
    return max((d for d in new if d is not None), default=0)


def riccati_chain(S: int, with_c: bool = False) -> int:
    """Dependent FP32 operations of one Riccati step's loop-carried chain in
    csrc/riccati_backward.cu, from one step's V_xx (or V_x) to the next's,
    every sum in the reference order and the division one operation, as
    ``i2c_filter_chain`` counts. T of them in a row bound the horizon's time."""
    return max(_riccati_step_depth(S, 0, None, with_c), _riccati_step_depth(S, None, 0, with_c))


def _clamp_depth(d):
    """A clip: a max and a min."""
    return _dep(_dep(d))


def _pendulum_step_depths(x, u):
    """Depths of the pendulum functor's next state (csrc/models.cuh), from
    the depths of its state and action."""
    torque = _clamp_depth(u)
    newthdot = _dep(x[1], _dep(_dep(_dep(_dep(_dep(x[0]))), _dep(torque))))  # sin(th + pi)
    newth = _dep(x[0], _dep(newthdot))
    return [newth, _clamp_depth(newthdot)]


def _cartpole_step_depths(x, u):
    """Depths of the cart-pole functor's next state."""
    action = _dep(_clamp_depth(u))  # clip, * FORCE_MAG
    s, c = _dep(x[2]), _dep(x[2])  # sinf, cosf
    td2, c2 = _dep(x[3], x[3]), _dep(c, c)
    num1 = _dep(_dep(_dep(_dep(_dep(td2), s), _dep(_dep(s), c)), _dep(action)), _dep(x[1]))
    den = _dep(_dep(c2))
    num2 = _dep(_dep(_dep(_dep(_dep(td2), s), c), _dep(s)),
                _dep(_dep(_dep(action, _dep(x[1]))), c))
    return [_dep(x[0], _dep(x[1])), _dep(x[1], _dep(_dep(num1, den))), _dep(x[2], _dep(x[3])),
            _dep(x[3], _dep(_dep(num2, den)))]


def _acrobot_dsdt_depths(s, a):
    cos2, sin2 = _dep(s[1]), _dep(s[1])
    d1 = _dep(_dep(_dep(None, _dep(_dep(None, _dep(cos2))))))  # + I1 + I2 folded: two adds
    d1 = _dep(d1)
    d2 = _dep(_dep(_dep(None, _dep(cos2))))
    phi2 = _dep(_dep(_dep(_dep(s[0], s[1]))))  # (t1 + t2 - pi/2), cos, * k
    phi1 = _dep(_dep(_dep(_dep(_dep(_dep(s[3], s[3])), sin2),
                          _dep(_dep(_dep(_dep(s[3]), s[2]), sin2))),
                     _dep(_dep(_dep(s[0])))), phi2)
    dd2 = _dep(_dep(_dep(_dep(a, _dep(_dep(d2, d1), phi1)),
                         _dep(_dep(_dep(s[2], s[2])), sin2)), phi2),
               _dep(None, _dep(_dep(d2, d2), d1)))
    dd1 = _dep(_dep(_dep(_dep(d2, dd2), phi1)), d1)
    return [s[2], s[3], dd1, dd2]


def _acrobot_step_depths(x, u):
    """Depths of the acrobot functor's next state: RK4 over dsdt, the wraps
    (fmodf, the sign test's add, the offsets) and the velocity clips."""
    k1 = _acrobot_dsdt_depths(x, u)
    y = [_dep(x[i], _dep(k1[i])) for i in range(4)]
    k2 = _acrobot_dsdt_depths(y, u)
    y = [_dep(x[i], _dep(k2[i])) for i in range(4)]
    k3 = _acrobot_dsdt_depths(y, u)
    y = [_dep(x[i], _dep(k3[i])) for i in range(4)]
    k4 = _acrobot_dsdt_depths(y, u)
    ns = [_dep(x[i], _dep(_dep(_dep(_dep(k1[i], _dep(k2[i])), _dep(k3[i])), k4[i])))
          for i in range(4)]
    wrap = lambda d: _dep(_dep(_dep(_dep(d))))  # noqa: E731  - lo, fmodf, + span, + lo
    return [wrap(ns[0]), wrap(ns[1]), _clamp_depth(ns[2]), _clamp_depth(ns[3])]


STEP_DEPTHS = {"pendulum": _pendulum_step_depths, "cartpole_swingup": _cartpole_step_depths,
               "acrobot": _acrobot_step_depths}


def admm_chain(n: int) -> int:
    """Dependent FP32 operations one ADMM iteration carries into the next,
    as the function needs them (the reference's row sum starts from its
    first product): v = rho*(z - y) - g (3), the first product (1), the
    row's n - 1 adds in order (n - 1), u' = alpha*u + (1 - alpha)*z (2),
    + y and the clip's two compares (3), and y+ = (u' + y) - z+ after the
    clip (1). The other products run beside the adds; the kernel's own add
    of its first product to 0, the round trip of v through shared memory
    and the zero terms up to the register form's row width (n rounded up
    to a multiple of 4) are costs of the design, left out."""
    return 3 + 1 + (n - 1) + 2 + 3 + 1


def linesearch_chain(name: str) -> int:
    """Dependent FP32 operations of one feedback step's loop-carried chain in
    csrc/fused_linesearch.cu: from one step's state through the feedback
    sum (in the reference order), the clip and the model functor's step to
    the next state; each libm call (sinf, cosf, fmodf) and each division one
    operation, as ``riccati_chain`` counts, so that T of them in a row are a
    lower bound of the horizon's time. The step's inputs (gains, reference
    state, us + alpha*ks) and the stage cost are off the chain."""
    S = len(STEP_DEPTHS[name]([0] * 4, 0))
    fb = _sum(_dep(None, _dep(0, None)) for _ in range(S))  # K_i * (x_i - xref_i)
    u = _clamp_depth(_dep(None, fb))
    return max(STEP_DEPTHS[name]([0] * S, u))


def derivs_ops(model) -> int:
    """FP32 operations fused_derivs needs per point, a lower bound counted
    from csrc/fused_derivs.cu: one primal pass of dynamics + transform (the
    rollout step without its cost and running sum), S+1 tangent pushes of
    at least as many operations each, the residual c, and the Gauss-Newton
    products over the nonzero entries of W_sym."""
    S = model.state_size
    D = Z = S + 1
    W = np.asarray(model.state_cost.W)
    Wsym = 0.5 * (W + W.T)
    nnz, rows = int((Wsym != 0).sum()), int((Wsym != 0).any(axis=1).sum())
    cost_ops = 4 * len(model.state_cost.nz) + 2
    primal = STEP_OPS[model.name] - cost_ops - 1
    gn = (Z + 2 * nnz) + D * (2 * rows + 1) + D * (2 * nnz + D * (2 * rows + 1))
    return (1 + D) * primal + 2 * S * D + gn


def ilqr_derivs_for(name, B, T, dev):
    """The Riccati kernel's inputs at an iLQR iteration: the model's exact
    derivatives along rollouts of the solver's initial plans from small
    random starts (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u)."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR
    model = REGISTRY[name]
    solver = ILQR(model=model, T=T)
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = 0.3 * torch.randn((B, model.state_size), generator=gen, device=dev)
    us = solver.init_state_batch(B, gen, dev).planned_us
    gz = torch.zeros((T, model.goal_size), device=dev)
    xs, _ = simulate_trajectory(model, x0, us, gz)
    return [t.contiguous() for t in solver.derivatives(xs, us, gz)]


def derivs_inputs_for(model, B, T, seed, rolled, dev):
    """fused_derivs' inputs: plans with some controls on the action bounds
    and, rolled, the states they roll out to from random starts, else
    uniform states (for the pendulum, angles on both sides of the wrap)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    rng = np.random.default_rng(seed)
    S = model.state_size
    hi = float(model.bounds_high[0])
    us = rng.uniform(-1.2, 1.2, (B, T, 1)).astype(np.float32) * (0.3 * hi if rolled else hi)
    us[::7, ::5], us[1::7, ::5] = hi, -hi
    us = torch.from_numpy(np.clip(us, -hi, hi)).to(dev)
    gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (T, S + 1)).astype(np.float32)).to(dev)
    if rolled:
        x0 = torch.from_numpy((0.3 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
        xs, _ = simulate_trajectory(model, x0, us, gz)
    else:
        span = 4.0 if model.name == "pendulum" else 1.2
        xs = torch.from_numpy(
            rng.uniform(-span, span, (B, T + 1, S)).astype(np.float32)).to(dev)
    return xs.contiguous(), us.contiguous(), gz


def sqp_riccati_inputs_for(B, T, dev):
    """The Riccati kernel's inputs at an SQP iteration of configuration 4
    (SQP._subproblem on the fused tier): the acrobot's Gauss-Newton terms
    along rolled-out trajectories, c = 0, R + reg with reg = 1e-6, mu = 0.
    Returns (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c)."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs
    from benchmarking_mpc_solvers_tpu_torch.ops.linearize import gn_terminal_terms
    model = REGISTRY["acrobot"]
    xs, us, gz = derivs_inputs_for(model, B, T, 9, True, dev)
    A, Bd, c, Q, R, M, q, r = fused_derivs(model, xs, us, gz)
    qf, Qf = gn_terminal_terms(model, xs[:, -1], gz[-1])
    l_x = torch.cat([q, qf[:, None]], dim=1).contiguous()
    l_xx = torch.cat([Q, Qf[:, None]], dim=1).contiguous()
    return [l_x, r.contiguous(), l_xx, (R + 1e-6).contiguous(), M.contiguous(), A.contiguous(),
            Bd.contiguous(), torch.zeros((B,), device=dev), torch.zeros_like(c)]


def ls_inputs_for(model, B, T, seed, dev):
    """The line-search kernel's inputs at an iteration: small random plans,
    gains and feedforward terms, and the reference trajectory the plans roll
    out to from random starts. Returns (x0, us, ks, Ks, xref, g_z)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    rng = np.random.default_rng(seed)
    S = model.state_size
    x0 = torch.from_numpy((0.3 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
    us = torch.from_numpy((0.5 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
    gz = torch.zeros((T, model.goal_size), device=dev)
    xref, _ = simulate_trajectory(model, x0, us, gz)
    ks = torch.from_numpy((0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
    Ks = torch.from_numpy((0.05 * rng.standard_normal((B, T, 1, S))).astype(np.float32)).to(dev)
    return x0, us, ks, Ks, xref.contiguous(), gz


def qp1_problem_for(B, dev):
    """What QP-MPC configuration 1 hands the ADMM kernel (shared layout,
    n = 20) at B pendulum states jittered around the start."""
    from benchmarking_mpc_solvers_tpu_torch.envs import PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC
    solver = QPMPC(model=PendulumEnv.model, T=QP1_T, method="admm", iters=QP1_ITERS)
    xs = PendulumEnv.start_state(dev).expand(B, -1) + 0.3 * torch.randn(
        (B, 2), generator=torch.Generator(device=dev).manual_seed(10), device=dev)
    return solver.admm_problem(xs)


def random_qps_for(B, n, per_problem, per_bounds, seed, dev):
    """(Minv, g, lo, hi) of B random box-QPs of n variables: Minv (n, n)
    shared or (B, n, n) per problem, bounds (n,) or (B, n) per problem."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(((B,) if per_problem else ()) + (n, n))
    H = a @ np.swapaxes(a, -1, -2) / n + np.eye(n)
    shape = (B, n) if per_bounds else (n,)
    arrays = (np.linalg.inv(H + np.eye(n)), 2.0 * rng.standard_normal((B, n)),
              -rng.uniform(0.2, 1.0, shape), rng.uniform(0.2, 1.0, shape))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def sass_functions(sass: str) -> dict:
    """{mangled name: [(address, instruction), ...]} of a cuobjdump -sass dump."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _branch_target(ins: str):
    m = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def fast_path_count(ins, head: int, tail: int) -> int:
    """Instructions one trip of the loop ins[head..tail] (indices; tail its
    back-edge) issues on its fast path: a forward branch that jumps over a
    call (a division's or a square root's slow path) or over a loop (a sine's
    or cosine's argument reduction for huge arguments) is taken, any other
    unconditional one is followed, any other conditional one falls through."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    n, i = 0, head
    while i <= tail:
        a, text = ins[i]
        n += 1
        tgt = _branch_target(text)
        if i == tail or tgt is None or tgt <= a or tgt not in at:
            i += 1
            continue
        j = at[tgt]
        skipped = ins[i + 1:j]
        jumps_slow = any("CALL" in t or ((b := _branch_target(t)) is not None and b <= x)
                         for x, t in skipped)
        i = j if (not text.startswith("@") or jumps_slow) else i + 1
    return n


# The cart-pole rollout loop of kernels 3, 1 and 2 in their SASS, by source:
# the function (the first of the names found: kernel 1's noise-cache form,
# else an untemplated build from before it had one) and the least count of
# each instruction that marks the loop. Kernels 3 and 1 draw noise in it
# (the square root's MUFU.RSQ) beside the model's two divisions (MUFU.RCP);
# kernel 2 draws none, and its loop is the one with the two divisions and
# the load of us (LDG).
SASS_LOOPS = {
    "fused_cem.cu": (("fused_cem_kernelIN4bmpc8CartPoleE",), {"MUFU.RSQ": 1, "MUFU.RCP": 2}),
    "fused_mppi.cu": (("fused_mppi_kernelIN4bmpc8CartPoleELb1E",
                       "fused_mppi_kernelIN4bmpc8CartPoleE"), {"MUFU.RSQ": 1, "MUFU.RCP": 2}),
    "fused_rollout.cu": (("fused_rollout_kernelIN4bmpc8CartPoleE",), {"MUFU.RCP": 2, "LDG": 1}),
}


def rollout_loop_count(sass: str, source: str):
    """The fast-path instructions per trip of the rollout's time loop in a
    build of ``source`` (``SASS_LOOPS``): the innermost loop that holds the
    instructions that mark it. Returns (count, static instructions of the
    loop), or None where no such function or loop is found."""
    names, marks = SASS_LOOPS[source]
    funcs = sass_functions(sass)
    ins = next((v for name in names for k, v in funcs.items() if name in k), None)
    if ins is None:
        return None
    best = None
    for i, (a, text) in enumerate(ins):
        tgt = _branch_target(text)
        if tgt is None or tgt > a:
            continue
        head = next(j for j, (x, _) in enumerate(ins) if x == tgt)
        body = [t for _, t in ins[head:i + 1]]
        if (all(sum(m in t for t in body) >= n for m, n in marks.items())
                and (best is None or i - head < best[1] - best[0])):
            best = (head, i)
    if best is None:
        return None
    return fast_path_count(ins, *best), best[1] - best[0] + 1


def sass_loop(library: Path, source: str):
    """``rollout_loop_count`` of a built library of ``source`` (cuobjdump),
    or None where the toolkit has no cuobjdump or no loop is found."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return None
    dump = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True)
    return rollout_loop_count(dump.stdout, source) if dump.returncode == 0 else None


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over reps of CUDA events around one call of fn on an idle
    card: the time holds the call's host work before its launch (a
    wrapper's checks and allocations) as well as its device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# cycles the sleeping kernel spins while the host enqueues the timed calls
SLEEP_CYCLES = 20_000_000
QUEUED_CALLS = 20


def device_time_ms(fn) -> float:
    """Device time of one call of fn: CUDA events around QUEUED_CALLS calls
    queued behind a sleeping kernel, per call. The host has enqueued them
    before the card reaches them, so its work before each launch stays out."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(QUEUED_CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / QUEUED_CALLS


def episode_seconds(run, reps: int, warmup: bool = True):
    """Host-clock times of whole episodes, each ending in a synchronise,
    after one untimed warm-up episode (left out for the long episodes that
    the launch-count run has already warmed)."""
    if warmup:
        run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def mppi_inputs(model, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    S = model.state_size
    plan = rng.uniform(-0.5, 0.5, (T, B)).astype(np.float32)
    x0 = rng.uniform(-1.0, 1.0, (S, B)).astype(np.float32)
    gz = rng.uniform(-0.2, 0.2, (T, S + 1)).astype(np.float32)
    return [torch.from_numpy(a).to(dev).contiguous() for a in (plan, x0, gz)]


def compare(name, got, want):
    """Max abs and rel error of got against want, each printed beside the
    reference value where it occurs; fails beyond the tolerance. Entries
    where the plain version is not finite must be equal in the kernel's
    output (both overflowed alike) and are left out of the errors."""
    torch.cuda.synchronize()
    bad = ~torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), ~bad) or not torch.equal(
            torch.nan_to_num(got[bad], nan=0.0), torch.nan_to_num(want[bad], nan=0.0)):
        fail(f"{name}: kernel output not finite where the plain version is, or not alike")
    got, want = got[~bad], want[~bad]
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ia, ir = int(err.argmax()), int(rel.argmax())
    max_abs, max_rel = float(err.flatten()[ia]), float(rel.flatten()[ir])
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"{name}: max_abs_err={max_abs:.3e} at |want|={float(want.flatten()[ia].abs()):.3e}, "
          f"max_rel_err={max_rel:.3e} at |want|={float(want.flatten()[ir].abs()):.3e}, "
          f"|want| max {float(want.abs().max()):.3e}"
          f"{f', {int(bad.sum())} non-finite alike' if bool(bad.any()) else ''} "
          f"(rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'EXCEEDED'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs, max_rel


def exact(name, got, want):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: kernel and plain version differ ({int((got != want).sum())} entries)")
    print(f"{name}: identical", flush=True)


def exact_nan(name, got, want):
    """``exact`` for float32 outputs that may hold NaN: NaN at the same
    places in both, every other entry the same bits (a zero's sign too)."""
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan) or not torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)):
        fail(f"{name}: kernel and plain version differ")
    print(f"{name}: identical{f' ({int(nan.sum())} NaN alike)' if bool(nan.any()) else ''}",
          flush=True)


def profile_window(label, smi, fn):
    """Device time by kernel over one call of fn, and the device's busy
    share of the wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")),
        key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    if busy_ms > 0:
        n_kernels = sum(r[2] for r in by_kernel)
        print(f"[{smi}] profiled {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
              f"{n_kernels} device kernels", flush=True)
        for key, ms, count in by_kernel[:6]:
            print(f"  {ms:8.3f} ms  x{count:<6d} {key[:90]}", flush=True)
        return n_kernels
    print(f"profiled {label}: no device time recorded (not measured)", flush=True)
    return None


def report_episodes(smi, label, times, batch, steps):
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else (med, med, med)
    print(f"[{smi}] episode {label} B={batch} x {steps} steps: median {med * 1e3:.3f} ms "
          f"(quartiles {q1 * 1e3:.3f}-{q3 * 1e3:.3f} ms, n={len(times)}) = "
          f"{batch * steps / med:.1f} solves/s", flush=True)
    return med


def bound(bytes_, ops, chain_ms=None):
    """The least time in ms for the work, and what sets it: the bytes at the
    card's memory rate, the operations at its FP32 rate and, where given, a
    dependent chain's latency."""
    b = {"bytes": bytes_ / PEAK_BYTES * 1e3, "operations": ops / PEAK_FP32 * 1e3}
    if chain_ms is not None:
        b["chain"] = chain_ms
    return max(b.values()), max(b, key=b.get)


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def chain_ms(steps: int, chain: int, clock_mhz: float) -> float:
    """steps dependent chains of ``chain`` operations at the least latency
    each, at the card's maximum SM clock."""
    return steps * chain * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)


def i2c_first_iteration_inputs_for(env_, T, B, seed, dev):
    """What ``I2C._smooth_once`` hands the smoother at a solve's first
    iteration from jittered starts and small random plans."""
    from benchmarking_mpc_solvers_tpu_torch.solvers import I2C
    solver = I2C(model=env_.model, T=T)
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = env_.model.state_size
    xs = env_.start_state(dev).expand(B, -1) + 0.1 * torch.randn((B, S), generator=gen, device=dev)
    us = 0.3 * torch.randn((B, T, env_.model.action_size), generator=gen, device=dev)
    gz = torch.zeros((T, env_.model.goal_size), device=dev)
    F, m, J, z0, mu0 = solver._smoother_inputs(xs, us, gz)
    return [t.contiguous() for t in (F, m, J, z0, solver._obs_noise(solver.alphas()[0], dev),
                                     mu0, *solver._prior_covs(dev), gz)]


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    t_start = time.perf_counter()

    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.envs import (
        AcrobotEnv, CartPoleSwingUpEnv, PendulumEnv)
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_costs_tm, fused_rollout_costs_tm_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import launch_config as rollout_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import (
        fused_cem_step, fused_cem_step_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import launch_config as cem_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import (
        fused_derivs, fused_derivs_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
        fused_linesearch, fused_linesearch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import launch_config as ls_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        fused_mppi_step, fused_mppi_step_reference, pick_lanes)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import launch_config as mppi_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import (
        i2c_filter, i2c_filter_reference, i2c_rts_smooth, i2c_rts_smooth_reference,
        i2c_smooth_batch, i2c_smooth_batch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import launch_config as i2c_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import (
        admm_iterate, admm_iterate_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import launch_config as admm_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
        riccati_backward_batch, riccati_backward_batch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP

    counters = (fused_mppi_step, fused_rollout_costs_tm, fused_cem_step,
                riccati_backward_batch, fused_linesearch, fused_derivs, admm_iterate,
                i2c_filter, i2c_rts_smooth)

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose="--ptxas" in sys.argv)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}", flush=True)
    for src, (_, log) in built.items():
        if log.strip():
            print(f"--- nvcc {src}\n{log.strip()}", flush=True)
    cfg33, cfg55 = i2c_launch_config(3, 3, I2C6_B), i2c_launch_config(5, 5, I2CS_B)
    for (D, Z, B), c in (((3, 3, I2C6_B), cfg33), ((5, 5, I2CS_B), cfg55)):
        print(f"i2c kernels at D={D}, Z={Z}, B={B}, rings of {c['stages']} stages: " + "; ".join(
            f"{name} {k['threads']} threads = {k['scenarios_per_block']} scenarios per block, "
            f"{k['chunk']} steps per stage, {k['shared_bytes']} shared bytes, {k['registers']} "
            f"registers, {k['blocks_per_sm']} blocks per SM"
            for name, k in (("filter", c["filter"]), ("smoother", c["rts"]))), flush=True)

    # 3. kernel vs plain version, on the card
    errs = {}

    # MPPI step: the bench shape on every model; then, on every model, K = 48
    # (lanes with one sample and lanes with two) with a ragged last block, and
    # a K*T whose noise cache is above the kernel's budget (pass 2 redraws
    # the noise); and the sweep's MPPI row (two samples a lane). Each case
    # names the form its launch must take
    def mppi_check(label, model, B, T, K, seed, cache):
        plan, x0, gz = mppi_inputs(model, B, T, 1, dev)
        cfg = mppi_launch_config(model, T, K, B)
        label = (f"fused_mppi_step[{label}: {model.name}, B={B}, T={T}, K={K}, seed={seed}, "
                 f"{'noise cache' if cfg['noise_cache'] else 'redraw'}]")
        if cfg["noise_cache"] != cache:
            fail(f"{label}: launch {cfg}, expected noise_cache={cache}")
        lanes = pick_lanes(B)
        got = fused_mppi_step(model, K, 1.0, 1.0, lanes, plan, x0, gz, seed)
        want = fused_mppi_step_reference(model, K, 1.0, 1.0, lanes, plan, x0, gz, seed)
        return compare(label, got, want)

    for name, B, seed in [("cartpole_swingup", BATCH, 7), ("pendulum", 3000, 2**31 - 2),
                          ("acrobot", 5000, 12345)]:
        errs.setdefault("fused_mppi_step", mppi_check(
            "bench shape", REGISTRY[name], B, HORIZON, K_SAMPLES, seed, True))
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        mppi_check("K=48, ragged last block", REGISTRY[name], 1001, 17, 48, 2**31 - 2, True)
        mppi_check("cache above its budget", REGISTRY[name], 777, 90, 48, 12345, False)
    mppi_check("the sweep's MPPI row", REGISTRY["cartpole_swingup"], MPPI_SWEEP_B, HORIZON,
               MPPI_SWEEP_K, 7, True)

    # rollout costs, bit for bit (each rollout sums its steps in the plain
    # version's order): the MPPI two-stage shape on every model and a ragged
    # N (not a multiple of the block), then the CEM two-stage shape
    def rollout_check(model, N, T, seed):
        rng = np.random.default_rng(seed)
        x0 = torch.from_numpy(rng.uniform(-1, 1, (model.state_size, N)).astype(np.float32)).to(dev)
        us = torch.from_numpy(rng.uniform(-1.5, 1.5, (T, N)).astype(np.float32)).to(dev)
        gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)).to(dev)
        got = fused_rollout_costs_tm(model, x0, us, gz)
        want = fused_rollout_costs_tm_reference(model, x0, us, gz)
        label = f"fused_rollout_costs_tm[{model.name}, N={N}, T={T}]"
        exact_nan(label, got, want)
        return compare(label, got, want)

    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        errs.setdefault("fused_rollout_costs_tm", rollout_check(
            REGISTRY[name], BATCH * K_SAMPLES, HORIZON, 2))
        rollout_check(REGISTRY[name], 4097, 23, 5)
    rollout_check(REGISTRY["cartpole_swingup"], CEM_B * CEM_K, CEM_T, 6)

    # CEM step, the plan and the elite masks bit for bit: the sweep shape, a
    # multi-tile ragged B, the seed 2**31 - 2; then the kernel's edges on every
    # model: K not a multiple of the warp (lanes with one and with two
    # samples), one step, every sample an elite, a ragged last block
    def cem_check(label, model, B, T, K, n_elite, max_iter, seed):
        plan, x0, gz = mppi_inputs(model, B, T, 3, dev)
        args = (model, K, n_elite, max_iter, 0.2, 1.0, pick_lanes(B), plan, x0, gz, seed)
        got, got_masks = fused_cem_step(*args, return_masks=True)
        want, want_masks = fused_cem_step_reference(*args, return_masks=True)
        label = (f"fused_cem_step[{label}, B={B}, T={T}, K={K}, n_elite={n_elite}, "
                 f"max_iter={max_iter}, seed={seed}]")
        exact(f"{label} elite masks", got_masks, want_masks)
        exact_nan(f"{label} plan", got, want)
        return got, want

    for name, B, seed in [("cartpole_swingup", CEM_B, 7), ("pendulum", 3000, 2**31 - 2),
                          ("acrobot", 5000, 12345)]:
        got, want = cem_check(name, REGISTRY[name], B, CEM_T, CEM_K, CEM_ELITE, CEM_ITERS, seed)
        errs.setdefault("fused_cem_step", compare(f"fused_cem_step[{name}] plan", got, want))
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        for B, T, K, n_elite, max_iter in ((1001, 17, 48, CEM_ELITE, CEM_ITERS),
                                           (333, 1, CEM_K, CEM_ELITE, 2),
                                           (777, 33, 48, 48, 1), (100, 5, 33, 5, CEM_ITERS)):
            cem_check(name, REGISTRY[name], B, T, K, n_elite, max_iter, 2**31 - 2)

    # Riccati: every model's derivatives along random plans at iLQR's shape,
    # then random well-conditioned blocks with non-PD steps (ok mixed) and
    # the with_c form (SQP's: mu = 0, no PD check)
    def model_derivs(name, B, T):
        return ilqr_derivs_for(name, B, T, dev)

    def random_derivs(B, T, S, seed):
        rng = np.random.default_rng(seed)
        eye = np.eye(S)
        sym = lambda m: 0.5 * (m + np.swapaxes(m, -1, -2))  # noqa: E731
        l_uu = 0.5 + rng.uniform(size=(B, T, 1, 1))
        l_uu[::5, T // 3] = -50.0  # every 5th scenario has a non-PD step
        arrays = (rng.standard_normal((B, T + 1, S)), rng.standard_normal((B, T, 1)),
                  sym(rng.standard_normal((B, T + 1, S, S))) + 2.0 * eye, l_uu,
                  rng.standard_normal((B, T, 1, S)),
                  0.5 * eye + 0.1 * rng.standard_normal((B, T, S, S)),
                  rng.standard_normal((B, T, S, 1)), 0.3 * rng.standard_normal((B, T, S)))
        return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]

    def riccati_check(label, d, mu, c=None, check_pd=True, with_c=False):
        """Kernel against plain version, every output bit for bit (NaN alike)."""
        got = riccati_backward_batch(*d, mu, c, check_pd=check_pd, with_c=with_c)
        want = riccati_backward_batch_reference(*d, mu, c, check_pd=check_pd, with_c=with_c)
        exact(f"riccati_backward_batch[{label}] ok ({int(want[2].sum())} of "
              f"{want[2].numel()} true)", got[2], want[2])
        exact_nan(f"riccati_backward_batch[{label}] ks", got[0], want[0])
        exact_nan(f"riccati_backward_batch[{label}] Ks", got[1], want[1])
        return got, want

    ones = torch.ones((ILQR_B,), device=dev)
    riccati_main = model_derivs("cartpole_swingup", ILQR_B, ILQR_T)
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        d = riccati_main if name == "cartpole_swingup" else model_derivs(name, ILQR_B, ILQR_T)
        got, want = riccati_check(f"{name} derivatives, B={ILQR_B}, T={ILQR_T}", d, ones)
        e = max(compare(f"riccati_backward_batch[{name}] ks", got[0], want[0]),
                compare(f"riccati_backward_batch[{name}] Ks", got[1], want[1]))
        errs["riccati_backward_batch"] = max(errs.get("riccati_backward_batch", e), e)
    *d, c = random_derivs(ILQR_B, ILQR_T, 4, 6)
    mu = torch.from_numpy(np.random.default_rng(7).choice(
        [1e-6, 1e-3, 1.0, 32.0], ILQR_B).astype(np.float32)).to(dev)
    got, want = riccati_check("non-PD steps", d, mu)
    n_ok = int(want[2].sum())
    if not 0 < n_ok < ILQR_B:
        fail(f"riccati non-PD case: ok is not mixed ({n_ok} of {ILQR_B})")
    zero = torch.zeros((ILQR_B,), device=dev)
    riccati_check("with_c", d, zero, c, check_pd=False, with_c=True)
    sq = sqp_riccati_inputs_for(SQP_B, SQP_T, dev)  # timed below
    riccati_check(f"SQP's inputs (acrobot, with_c, mu = 0), B={SQP_B}, T={SQP_T}", sq[:7], sq[7],
                  sq[8], check_pd=False, with_c=True)
    # the kernel's edges: every S (an entry per lane in groups of 1, 4 or 16
    # lanes at S <= 4, entries S*S..G-1 idle; one thread per scenario above),
    # a ragged last block, a horizon of one step and one past one and two
    # stages (stages of 16 steps at S <= 4, else 4), a NaN in one scenario,
    # inputs at a storage offset of one float
    for S_ in range(1, 9):
        for T_ in (1, 17, 33):
            *dd, cc = random_derivs(1001, T_, S_, 40 + S_)
            mm = torch.from_numpy(np.random.default_rng(S_).choice(
                [0.0, 1e-3, 1.0, 32.0], 1001).astype(np.float32)).to(dev)
            riccati_check(f"random, S={S_}, ragged B=1001, T={T_}", dd, mm)
            riccati_check(f"random, S={S_}, ragged B=1001, T={T_}, with_c", dd, mm, cc,
                          check_pd=False, with_c=True)
    *dn, cn = random_derivs(300, 20, 4, 50)
    mn = torch.ones((300,), device=dev)
    clean = riccati_backward_batch(*dn, mn, cn, check_pd=True, with_c=True)
    if not (torch.isfinite(clean[1][9]).all() and bool(clean[2][9])):
        fail("riccati NaN case: scenario 9 is not clean before the NaN")
    dn[5][9, 3, 0, 0] = float("nan")  # f_x of scenario 9 at t = 3
    got, _ = riccati_check("NaN in f_x of scenario 9, B=300, T=20, with_c", dn, mn, cn,
                           with_c=True)
    others = torch.arange(300, device=dev) != 9
    if not (torch.isnan(got[0][9, :3]).all() and torch.isnan(got[1][9, :3]).all()
            and torch.isnan(got[1][9, 3, 0, 0]) and bool(got[2][9]) is False and all(
            torch.equal(g[others], w[others]) or torch.equal(  # NaN alike where it overflows
                torch.nan_to_num(g[others], nan=7.0), torch.nan_to_num(w[others], nan=7.0))
            for g, w in zip(got, clean))):
        fail("riccati: the NaN scenario's gains are not NaN from its step down, or it "
             "touched another")
    d_off = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t)
             for t in random_derivs(777, 30, 4, 51)]
    if not all(t.storage_offset() == 1 and t.is_contiguous() for t in d_off):
        fail("riccati: the offset views are not contiguous views at offset 1")
    *d_off, c_off = d_off
    riccati_check("random, S=4, B=777, T=30, views at a storage offset of one float, with_c",
                  d_off, torch.full((777,), 1e-3, device=dev), c_off, with_c=True)

    # line search, every output bit for bit: n_alpha=10, B=1024, T=100, both
    # flags, every model; SQP's step sizes (n_alpha=8); then the kernel's
    # edges: a horizon of one step and one past one and two stages of 16, a
    # ragged last group of scenarios, one alpha, and more alphas than a warp
    # (two blocks of alphas, the second ragged)
    alphas = ILQR(model=REGISTRY["cartpole_swingup"], T=ILQR_T).alphas(dev)
    sqp_alphas = SQP(model=REGISTRY["acrobot"], T=SQP_T).alphas(dev)

    def ls_check(label, model, alphas_, inputs, with_terminal, return_states):
        got = fused_linesearch(model, alphas_, *inputs, with_terminal=with_terminal,
                               return_states=return_states)
        want = fused_linesearch_reference(model, alphas_, *inputs, with_terminal=with_terminal,
                                          return_states=return_states)
        label = f"fused_linesearch[{label}, terminal={with_terminal}, states={return_states}]"
        exact_nan(f"{label} us", got[0], want[0])
        if return_states:
            exact_nan(f"{label} xs", got[1], want[1])
        exact_nan(f"{label} costs", got[-1], want[-1])
        return got, want

    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        model = REGISTRY[name]
        inputs = ls_inputs_for(model, ILQR_B, ILQR_T, 8, dev)
        for with_terminal in (True, False):
            for return_states in (False, True):
                got, want = ls_check(f"{name}, n_a={N_ALPHAS}, B={ILQR_B}, T={ILQR_T}", model,
                                     alphas, inputs, with_terminal, return_states)
                if name == "cartpole_swingup" and with_terminal and not return_states:
                    errs["fused_linesearch"] = max(  # the iLQR main path's flags
                        compare("fused_linesearch[iLQR's shape] us", got[0], want[0]),
                        compare("fused_linesearch[iLQR's shape] costs", got[1], want[1]))
        ls_check(f"{name}, SQP's step sizes n_a={len(sqp_alphas)}, B={SQP_B}, T={SQP_T}", model,
                 sqp_alphas, ls_inputs_for(model, SQP_B, SQP_T, 9, dev), True, True)
        for T_ in (1, 17, 33):
            inputs = ls_inputs_for(model, 1001, T_, 10 + T_, dev)
            for with_terminal in (True, False):
                for return_states in (False, True):
                    ls_check(f"{name}, n_a={N_ALPHAS}, ragged B=1001, T={T_}", model, alphas,
                             inputs, with_terminal, return_states)
        many = torch.pow(1.05, -torch.arange(45, dtype=torch.float32, device=dev))
        inputs = ls_inputs_for(model, 333, 17, 11, dev)
        for alphas_ in (alphas[:1], many):
            ls_check(f"{name}, n_a={len(alphas_)}, B=333, T=17", model, alphas_, inputs, True,
                     True)

    # derivatives: every model at SQP's shape along rolled-out trajectories
    # (some controls on the action bounds), and a ragged batch of uniform
    # states (for the pendulum, angles on both sides of the wrap)
    def derivs_inputs(model, B, T, seed, rolled):
        return derivs_inputs_for(model, B, T, seed, rolled, dev)

    derivs_names = ("A", "Bd", "c", "Q", "R", "M", "q", "r")
    for name in ("acrobot", "cartpole_swingup", "pendulum"):
        model = REGISTRY[name]
        for B, T, rolled in ((SQP_B, SQP_T, True), (999, 37, False)):
            inputs = derivs_inputs(model, B, T, 9, rolled)
            got, want = fused_derivs(model, *inputs), fused_derivs_reference(model, *inputs)
            label = (f"fused_derivs[{name}, B={B}, T={T}, "
                     f"{'rolled-out' if rolled else 'uniform'} states]")
            e = max(compare(f"{label} {key}", g, w) for key, g, w in zip(derivs_names, got, want))
            if name == "acrobot" and rolled:
                errs["fused_derivs"] = e  # the SQP main path's model and shape

    # ADMM: the shared layout on configuration 1's own problem (pendulum,
    # n=20, B=512), then random SPD problems per problem (n=20 and n=50),
    # ragged batches, bounds per problem
    def qp1_problem(B):
        return qp1_problem_for(B, dev)

    def random_qps(B, n, per_problem, per_bounds, seed):
        return random_qps_for(B, n, per_problem, per_bounds, seed, dev)

    admm_main = qp1_problem(QP1_B)
    admm_cases = [(f"shared, configuration 1, n={QP1_T}, B={QP1_B}", admm_main, QP1_ITERS),
                  (f"shared, configuration 1, n={QP1_T}, ragged B=509", qp1_problem(509), QP1_ITERS),
                  ("per problem, n=20, B=512", random_qps(512, 20, True, False, 11), 100),
                  ("per problem, n=20, ragged B=509, bounds per problem",
                   random_qps(509, 20, True, True, 12), 100),
                  ("per problem, n=50, B=256", random_qps(256, 50, True, False, 13), 60),
                  ("per problem, n=50, ragged B=251, bounds per problem",
                   random_qps(251, 50, True, True, 14), 60),
                  ("shared, n=50, ragged B=251", random_qps(251, 50, False, False, 15), 60),
                  # the forms' edges: register widths 4 to 16 (two problems a
                  # warp; the last warp of B=511 holds one), to 32, to 64 (two
                  # rows a lane), the shared-memory form from 65 to 240, the
                  # streaming form above (n=1100: more rows than threads)
                  ("shared, n=1, ragged B=7", random_qps(7, 1, False, False, 16), 100),
                  ("per problem, n=5, ragged B=77, bounds per problem",
                   random_qps(77, 5, True, True, 27), 100),
                  ("per problem, n=16, ragged B=511, bounds per problem",
                   random_qps(511, 16, True, True, 17), 100),
                  ("shared, n=17, ragged B=263", random_qps(263, 17, False, False, 18), 100),
                  ("per problem, n=32, ragged B=530, bounds per problem",
                   random_qps(530, 32, True, True, 19), 100),
                  ("shared, n=33, ragged B=131", random_qps(131, 33, False, False, 20), 60),
                  ("per problem, n=64, ragged B=129", random_qps(129, 64, True, False, 21), 60),
                  ("shared, n=65, ragged B=9, bounds per problem",
                   random_qps(9, 65, False, True, 22), 20),
                  ("per problem, n=240, B=3", random_qps(3, 240, True, False, 23), 20),
                  ("per problem, n=241, ragged B=5, bounds per problem",
                   random_qps(5, 241, True, True, 24), 10),
                  (f"shared, n={ADMM_BIG_N}, B={ADMM_BIG_B}",
                   random_qps(ADMM_BIG_B, ADMM_BIG_N, False, False, 25), ADMM_BIG_ITERS),
                  ("shared, n=1100, B=2", random_qps(2, 1100, False, False, 26), 4)]
    for label, args, iters in admm_cases:
        got = admm_iterate(*args, iters=iters)
        want = admm_iterate_reference(*args, iters=iters)
        exact(f"admm_iterate[{label}, {iters} iterations]", got, want)
        at_bound = float(((want == args[2]) | (want == args[3])).float().mean())
        print(f"  {100 * at_bound:.1f} % of its variables end on a bound", flush=True)
        if not bool(((got >= args[2]) & (got <= args[3])).all()):
            fail(f"admm_iterate[{label}]: iterate outside the box")
        e = compare(f"admm_iterate[{label}, {iters} iterations]", got, want)
        if args is admm_main:
            errs["admm_iterate"] = e  # the QP-MPC main path's problem

    # Kalman filter and RTS smoother, each against its plain version, bit for
    # bit: random problems (D = Z = 3 with a ragged batch, the sweep's shape
    # at D = Z = 5, D = 6 with Z = 4, per-scenario and shared R), a horizon of
    # one step, a NaN in one scenario's F, then the matrices of a real first
    # iteration on every model (cart-pole's at the sweep's shape are the
    # ones timed below)
    def i2c_random(seed, B, T, S, A, Z, shared_R, variant=None):
        """A random smoother problem. variant "offset": each array a
        contiguous view one float into a larger buffer; "zeros": a zero row
        of J, and negative zeros in F's action rows, J's first column and
        mu0's actions (zero dividends of both signs in the solves)."""
        rng = np.random.default_rng(seed)
        D = S + A
        F = np.zeros((B, T, D, D))
        F[:, :, :S, :S] = np.eye(S) * 0.9 + 0.05 * rng.standard_normal((B, T, S, S))
        F[:, :, :S, S:] = 0.3 * rng.standard_normal((B, T, S, A))
        m = 0.1 * rng.standard_normal((B, T, D))
        J = rng.standard_normal((B, T, Z, D))
        z0 = 0.2 * rng.standard_normal((B, T, Z))
        Rm = rng.standard_normal((B, Z, Z))
        R = np.einsum("bij,bkj->bik", Rm, Rm) * 0.1 + 0.5 * np.eye(Z)
        mu0 = np.concatenate([rng.standard_normal((B, S)), np.zeros((B, A))], axis=1)
        sig0, Qproc = np.zeros((D, D)), np.zeros((D, D))
        sig0[:S, :S], sig0[S:, S:] = 1e-8 * np.eye(S), 0.25 * np.eye(A)
        Qproc[:S, :S], Qproc[S:, S:] = 1e-6 * np.eye(S), 0.25 * np.eye(A)
        g = 0.1 * rng.standard_normal((T, Z))
        if variant == "zeros":
            F[:, :, S:, :], J[:, :, :, 0], mu0[:, S:] = -0.0, -0.0, -0.0
            J[:, :, 0, :] = 0.0
        arrays = (F, m, J, z0, R[0] if shared_R else R, mu0, sig0, Qproc, g)
        out = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]
        if variant == "offset":
            out = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in out]
        return out

    def i2c_first_iteration(env_, T, B, seed):
        return i2c_first_iteration_inputs_for(env_, T, B, seed, dev)

    def i2c_check(label, p):
        got, want = i2c_filter(*p), i2c_filter_reference(*p)
        for key, g, w in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), got, want):
            exact_nan(f"i2c_filter[{label}] {key}", g, w)
        if p[0].shape[1] > 1:
            exact_nan(f"i2c_rts_smooth[{label}]", i2c_rts_smooth(*got, p[0]),
                      i2c_rts_smooth_reference(*want, p[0]))
        out, out_plain = i2c_smooth_batch(*p), i2c_smooth_batch_reference(*p)
        exact_nan(f"i2c_smooth_batch[{label}]", out, out_plain)
        return got, want, out

    i2c_check("random, D=Z=3, ragged B=3000, T=25", i2c_random(20, 3000, 25, 2, 1, 3, False))
    i2c_check(f"random, D=Z=5, B={I2CS_B}, T={I2CS_T}, shared R",
              i2c_random(21, I2CS_B, I2CS_T, 4, 1, 5, True))
    i2c_check("random, D=6, Z=4, B=1000, T=12", i2c_random(22, 1000, 12, 5, 1, 4, False))
    i2c_check("random, D=4 (two actions), Z=6, B=333, T=9", i2c_random(23, 333, 9, 2, 2, 6, True))
    # the lane-group kernels' edges: a ragged last group and block, T one
    # past a stage, T over many passes of the ring, D = Z = 6, D = 1, views
    # with a storage offset of one float
    i2c_check("random, D=Z=3, B=4k+1=401, T=25", i2c_random(27, 401, 25, 2, 1, 3, False))
    # the filter walks T steps, the smoother T - 1: one past a stage of each,
    # and exactly one stage of the smoother, in its narrow and wide blocks
    for B in (13, 5001):
        c = i2c_launch_config(3, 3, B)
        fc, rc = c["filter"]["chunk"], c["rts"]["chunk"]
        for T in sorted({fc + 1, rc + 2, rc + 1}):
            i2c_check(f"random, D=Z=3, B={B}, T={T} (stages of {fc} and {rc} steps)",
                      i2c_random(28, B, T, 2, 1, 3, True))
    i2c_check("random, D=Z=5, B=77, T=200", i2c_random(29, 77, 200, 4, 1, 5, False))
    i2c_check("random, D=Z=6, B=301, T=20", i2c_random(30, 301, 20, 5, 1, 6, False))
    i2c_check("random, D=1, Z=2, B=64, T=17", i2c_random(31, 64, 17, 1, 0, 2, True))
    p_off = i2c_random(32, 257, 25, 2, 1, 3, False, "offset")
    if not all(t.storage_offset() == 1 and t.is_contiguous() for t in p_off):
        fail("i2c: the offset views are not contiguous views at offset 1")
    i2c_check("random, D=Z=3, B=257, T=25, views at a storage offset of one float", p_off)
    # zero dividends: the filter's solves on a zero row of J, the smoother's
    # factorisation on the negative zeros of sig_pred's action rows
    p_z = i2c_random(33, 3000, 10, 4, 1, 5, True, "zeros")
    got_z, _, _ = i2c_check("random, D=Z=5, B=3000, T=10, a zero row of J", p_z)
    neg = [torch.where(t == 0, torch.full_like(t, -0.0), t) for t in got_z]
    exact_nan("i2c_rts_smooth[every zero of its inputs negative]", i2c_rts_smooth(*neg, p_z[0]),
              i2c_rts_smooth_reference(*neg, p_z[0]))
    _, _, out = i2c_check("T=1, D=Z=3, B=100", i2c_random(24, 100, 1, 2, 1, 3, False))
    if out.shape != (100, 1, 3):
        fail("i2c_smooth_batch: a one-step horizon is misshapen")
    p_nan = i2c_random(25, 300, 9, 2, 1, 3, False)
    clean = i2c_smooth_batch(*p_nan)
    p_nan[0][7, 2, 0, 0] = float("nan")
    _, _, out = i2c_check("NaN in F of scenario 7, D=Z=3, B=300, T=9", p_nan)
    others = torch.arange(300, device=dev) != 7
    if not (torch.isnan(out[7]).all() and torch.equal(out[others], clean[others])):
        fail("i2c_smooth_batch: the NaN scenario is not all NaN, or it touched another")
    i2c_first_iteration_inputs = {}
    for env_, T, B in ((PendulumEnv, I2C6_T, I2C6_B), (CartPoleSwingUpEnv, I2CS_T, I2CS_B),
                       (AcrobotEnv, I2CS_T, 1024)):
        p = i2c_first_iteration(env_, T, B, 26)
        label = f"{env_.model.name} first iteration, B={B}, T={T}"
        got, want, out = i2c_check(label, p)
        i2c_first_iteration_inputs[env_.model.name] = (p, got)
        if env_ is CartPoleSwingUpEnv:  # the sweep's shape and model
            errs["i2c_filter"] = max(compare(f"i2c_filter[{label}] {key}", g, w) for key, g, w
                                     in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), got, want))
            errs["i2c_rts_smooth"] = compare(
                f"i2c_rts_smooth[{label}]", i2c_rts_smooth(*got, p[0]),
                i2c_rts_smooth_reference(*want, p[0]))

    # 4. main paths
    launches = {}
    env = CartPoleSwingUpEnv
    x0s = env.start_state(dev).expand(BATCH, -1).contiguous()
    solver = MPPI(model=env.model, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)

    def mppi_episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, solver, cfg, x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    def run_path(label, run, expect):
        """Drive one path with the counts at 0; check each expected count
        and that no other kernel launched."""
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        want = {fn.__name__: 0 for fn in counters}
        want.update(expect)
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        if not torch.isfinite(res.costs).all():
            fail(f"{label}: episode costs not finite")
        launches[label] = got
        print(f"main path ({label}): launches {expect}, mean episode cost "
              f"{float(res.costs.sum(1).mean()):.3f}", flush=True)
        return res

    res = run_path("mppi kernel tier", mppi_episode,
                   {"fused_mppi_step": cfg.warmstart + cfg.n_steps})
    if res.costs.shape != (BATCH, N_STEPS):
        fail("kernel-tier episode costs misshapen")
    run_path("mppi two-stage tier", lambda: mppi_episode(False),
             {"fused_rollout_costs_tm": cfg.n_steps})

    cem = CEM(model=env.model, T=CEM_T, K=CEM_K, n_elite=CEM_ELITE, max_iter=CEM_ITERS)
    cem_cfg = EpisodeConfig(n_steps=CEM_STEPS, warmstart=0, record_plans=False)
    cem_x0s = env.start_state(dev).expand(CEM_B, -1).contiguous()

    def cem_episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, cem, cem_cfg, cem_x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    run_path("cem kernel tier", cem_episode,
             {"fused_cem_step": cem_cfg.warmstart + cem_cfg.n_steps})
    run_path("cem two-stage tier", lambda: cem_episode(False),
             {"fused_rollout_costs_tm": cem_cfg.n_steps * CEM_ITERS})

    ilqr = ILQR(model=env.model, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False)
    ilqr_cfg = EpisodeConfig(n_steps=ILQR_STEPS, warmstart=ILQR_WARM, record_plans=False)
    ilqr_x0s = env.start_state(dev).expand(ILQR_B, -1).contiguous()

    def ilqr_episode():
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, ilqr, ilqr_cfg, ilqr_x0s, generator=gen, device=dev)

    # solve_batch runs max_iter outer iterations per call, without an early
    # exit: one Riccati and one line-search launch each
    ilqr_iters = (ILQR_WARM + ILQR_STEPS) * ILQR_ITERS
    run_path("ilqr", ilqr_episode,
             {"riccati_backward_batch": ilqr_iters, "fused_linesearch": ilqr_iters})
    print(f"ilqr: {ilqr_iters} outer iterations ran ({ILQR_WARM + ILQR_STEPS} solves x "
          f"{ILQR_ITERS})", flush=True)
    st = ilqr.init_state_batch(ILQR_B, torch.Generator(device=dev).manual_seed(0), dev)
    out = ilqr.solve_batch(st, ilqr_x0s, torch.zeros((ILQR_T, env.model.goal_size), device=dev))[0]
    # a solve that accepts no step returns the plan, or the clipped plan
    kept = ((out.planned_us == st.planned_us).flatten(1).all(dim=1)
            | (out.planned_us == env.model.clip_action(st.planned_us)).flatten(1).all(dim=1))
    print(f"ilqr: one solve from the initial plans accepted a step in {int((~kept).sum())} of "
          f"{ILQR_B} scenarios", flush=True)

    # the same configuration with Gauss-Newton Hessians: the stage
    # derivatives come from fused_derivs, one more launch per iteration
    ilqr_gn = ILQR(model=env.model, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False,
                   gauss_newton=True)

    def ilqr_gn_episode():
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, ilqr_gn, ilqr_cfg, ilqr_x0s, generator=gen, device=dev)

    run_path("ilqr gauss-newton", ilqr_gn_episode,
             {"fused_derivs": ilqr_iters, "riccati_backward_batch": ilqr_iters,
              "fused_linesearch": ilqr_iters})
    out_gn = ilqr_gn.solve_batch(st, ilqr_x0s,
                                 torch.zeros((ILQR_T, env.model.goal_size), device=dev))[0]
    kept_gn = ((out_gn.planned_us == st.planned_us).flatten(1).all(dim=1)
               | (out_gn.planned_us == env.model.clip_action(st.planned_us)).flatten(1).all(dim=1))
    print(f"ilqr gauss-newton: one solve from the same initial plans accepted a step in "
          f"{int((~kept_gn).sum())} of {ILQR_B} scenarios (exact Hessians: "
          f"{int((~kept).sum())})", flush=True)

    # why neither accepts: the backward pass's Q_uu > 0 test on the initial
    # plans, with Gauss-Newton derivatives, at the largest mu
    gz3 = torch.zeros((ILQR_T, env.model.goal_size), device=dev)
    xs3, _ = simulate_trajectory(env.model, ilqr_x0s, st.planned_us, gz3)
    d_gn = [t.contiguous() for t in ilqr_gn.derivatives(xs3, st.planned_us, gz3, True)]
    ok_gn = riccati_backward_batch(*d_gn, torch.full((ILQR_B,), ilqr_gn.mu_max, device=dev))[2]
    beyond = (st.planned_us.abs() > 1.0).flatten(1)
    zero_quu = ((d_gn[3][:, :, 0, 0] == 0) & (d_gn[6].abs().sum(dim=(2, 3)) == 0))
    print(f"ilqr gauss-newton: backward pass ok at mu={ilqr_gn.mu_max:g} in {int(ok_gn.sum())} of "
          f"{ILQR_B}; {100 * float(beyond.float().mean()):.1f} % of the initial plans' controls "
          f"lie beyond the action bounds, {int(zero_quu.any(dim=1).sum())} of {ILQR_B} plans "
          f"have a step with l_uu = 0 and f_u = 0 (Q_uu = 0 at any mu), and the terminal "
          f"Hessian's smallest diagonal entry is negative in "
          f"{int((d_gn[2][:, -1].diagonal(dim1=-2, dim2=-1).min(dim=1).values < 0).sum())} "
          f"of {ILQR_B}", flush=True)

    # SQP, configuration 4: acrobot, every scenario from the same start
    sqp = SQP(model=AcrobotEnv.model, T=SQP_T, max_iter=SQP_ITERS)
    sqp_cfg = EpisodeConfig(n_steps=SQP_STEPS, record_plans=False)
    sqp_x0s = torch.tensor(SQP_START, device=dev).expand(SQP_B, -1).contiguous()

    def sqp_episode():
        return run_episodes_fused(AcrobotEnv, sqp, sqp_cfg, sqp_x0s, device=dev)

    sqp_iters = SQP_STEPS * SQP_ITERS
    res = run_path("sqp", sqp_episode,
                   {"fused_derivs": sqp_iters, "riccati_backward_batch": sqp_iters,
                    "fused_linesearch": sqp_iters})
    if res.costs.shape != (SQP_B, SQP_STEPS) or float(res.true_actions.abs().max()) > 1.0:
        fail("sqp: episode misshapen or an action outside the box")
    # the reference's own check of an SQP solve (tests/test_qp.py): the plan
    # it returns rolls out cheaper than the plan it started from
    sqp_gz = torch.zeros((SQP_T, AcrobotEnv.model.goal_size), device=dev)
    sqp_st = sqp.init_state_batch(SQP_B, torch.Generator(device=dev).manual_seed(0), dev)
    _, cost0 = simulate_trajectory(AcrobotEnv.model, sqp_x0s, sqp_st.planned_us, sqp_gz)
    solved = sqp.solve_batch(sqp_st, sqp_x0s, sqp_gz)[0]
    _, cost1 = simulate_trajectory(AcrobotEnv.model, sqp_x0s, solved.planned_us, sqp_gz)
    print(f"sqp: one solve takes the plan's rollout cost from {float(cost0.mean()):.3f} to "
          f"{float(cost1.mean()):.3f} (mean of {SQP_B})", flush=True)
    if not bool((cost1 < cost0).all()):
        fail("sqp: a solve did not improve the plan's rollout cost")

    # QP-MPC, configuration 1 (the ADMM kernel, shared layout) and
    # configuration 2 (Riccati-ADMM, plain PyTorch)
    qp1 = QPMPC(model=PendulumEnv.model, T=QP1_T, method="admm", iters=QP1_ITERS)
    qp1_cfg = EpisodeConfig(n_steps=QP1_STEPS, record_plans=False)
    qp1_x0s = PendulumEnv.start_state(dev).expand(QP1_B, -1).contiguous()

    def qp1_episode():
        return run_episodes_fused(PendulumEnv, qp1, qp1_cfg, qp1_x0s, device=dev)

    res = run_path("qpmpc configuration 1", qp1_episode, {"admm_iterate": QP1_STEPS})
    if float(res.true_actions.abs().max()) > 2.0:
        fail("qpmpc configuration 1: an action outside the box")
    qp2 = QPMPC(model=env.model, T=QP2_T, iters=QP2_ITERS, **QP2_WEIGHTS)
    qp2_cfg = EpisodeConfig(n_steps=QP2_STEPS, record_plans=False)
    qp2_x0s = torch.tensor(QP2_START, device=dev).expand(QP2_B, -1).contiguous()

    def qp2_episode():
        return run_episodes_fused(env, qp2, qp2_cfg, qp2_x0s, device=dev)

    res = run_path("qpmpc configuration 2", qp2_episode, {})
    final_theta = float(res.true_states[:, -1, 2].abs().max())
    print(f"qpmpc configuration 2: max final pole angle {final_theta:.4f} rad from "
          f"{QP2_START[2]} rad, max |action| {float(res.true_actions.abs().max()):.4f}",
          flush=True)
    if not final_theta < QP2_START[2] or float(res.true_actions.abs().max()) > 1.0:
        fail("qpmpc configuration 2: the pole was not brought towards upright within the box")

    # I2C: configuration 6 (pendulum) and the sweep's row (cart-pole), one
    # launch of the filter and one of the smoother per iteration
    def jittered(env_, B, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (env_.start_state(dev).expand(B, -1) + 1e-3 * torch.randn(
            (B, env_.model.state_size), generator=gen, device=dev)).contiguous()

    i2c6 = I2C(model=PendulumEnv.model, T=I2C6_T, max_iter=I2C6_ITERS)
    i2c6_cfg = EpisodeConfig(n_steps=I2C6_STEPS, record_plans=False)
    i2c6_x0s = jittered(PendulumEnv, I2C6_B, 0)

    def i2c6_episode():
        return run_episodes_fused(PendulumEnv, i2c6, i2c6_cfg, i2c6_x0s, device=dev)

    n = I2C6_STEPS * I2C6_ITERS
    res = run_path("i2c configuration 6", i2c6_episode, {"i2c_filter": n, "i2c_rts_smooth": n})
    if res.costs.shape != (I2C6_B, I2C6_STEPS) or float(res.true_actions.abs().max()) > 2.0:
        fail("i2c configuration 6: episode misshapen or an action outside the box")
    c6 = res.costs
    early, late = float(c6[:, :10].mean()), float(c6[:, -10:].mean())
    print(f"i2c configuration 6: mean plant cost of the first 10 steps {early:.3f}, of the last "
          f"10 {late:.3f}; max |theta| at the end "
          f"{float(res.true_states[:, -1, 0].abs().max()):.3f}", flush=True)
    if not late < early:
        fail("i2c configuration 6: the plant cost did not fall over the episode")

    i2cs = I2C(model=env.model, T=I2CS_T, max_iter=I2CS_ITERS)
    i2cs_cfg = EpisodeConfig(n_steps=I2CS_STEPS, record_plans=False)
    i2cs_x0s = jittered(env, I2CS_B, 0)

    def i2cs_episode():
        return run_episodes_fused(env, i2cs, i2cs_cfg, i2cs_x0s, device=dev)

    n = I2CS_STEPS * I2CS_ITERS
    res = run_path("i2c sweep row", i2cs_episode, {"i2c_filter": n, "i2c_rts_smooth": n})
    if res.costs.shape != (I2CS_B, I2CS_STEPS) or float(res.true_actions.abs().max()) > 1.0:
        fail("i2c sweep row: episode misshapen or an action outside the box")
    # one solve improves the plan's rollout cost (the line search keeps the
    # old plan otherwise, so no scenario may get worse)
    i2cs_gz = torch.zeros((I2CS_T, env.model.goal_size), device=dev)
    i2cs_st = i2cs.init_state_batch(I2CS_B, torch.Generator(device=dev).manual_seed(0), dev)
    _, cost0 = simulate_trajectory(env.model, i2cs_x0s, i2cs_st.planned_us, i2cs_gz)
    solved = i2cs.solve_batch(i2cs_st, i2cs_x0s, i2cs_gz)[0]
    _, cost1 = simulate_trajectory(env.model, i2cs_x0s, solved.planned_us, i2cs_gz)
    print(f"i2c sweep row: one solve takes the plan's rollout cost from {float(cost0.mean()):.3f} "
          f"to {float(cost1.mean()):.3f} (mean of {I2CS_B}), lower in "
          f"{int((cost1 < cost0).sum())}", flush=True)
    if not bool((cost1 <= cost0 + 1e-3 * cost0.abs()).all() and (cost1 < cost0).any()):
        fail("i2c sweep row: a solve made a plan's rollout cost worse, or moved none")

    # small episodes on the card against the plain versions on the CPU
    def small_match(label, tol, run):
        on_card, on_cpu = run(dev), run("cpu")
        for field in ("costs", "true_states", "planned_actions"):
            got, want = getattr(on_card, field).cpu(), getattr(on_cpu, field)
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"small {label} episode {field}: card vs CPU plain max err "
                     f"{float((got - want).abs().max()):.3e}")
        print(f"small {label} episode: card matches the CPU plain version (tol {tol})",
              flush=True)

    xs_small = env.start_state("cpu").expand(64, -1) + 0.05 * torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 4)).astype(np.float32))
    seeds = [11, -7, 2**31 - 2, 5]
    small_cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=True)
    small_match("mppi kernel-tier", RTOL, lambda d: run_episodes_fused(
        env, MPPI(model=env.model, T=10, K=8), small_cfg, xs_small.to(d), seeds=seeds, device=d))
    small_match("cem kernel-tier", CEM_EPISODE_TOL, lambda d: run_episodes_fused(
        env, CEM(model=env.model, T=10, K=16, n_elite=4, max_iter=2), small_cfg, xs_small.to(d),
        seeds=seeds, device=d))
    plans = 0.5 * np.random.default_rng(4).standard_normal((8, 10, 1)).astype(np.float32)
    small_match("ilqr", ILQR_EPISODE_TOL, lambda d: run_episodes_fused(
        env, ILQR(model=env.model, T=10, max_iter=3, reference_accept=False), small_cfg,
        xs_small[:8].to(d), init_plans=plans, device=d))

    sqp_small = torch.tensor(SQP_START).expand(8, -1) + 0.02 * torch.from_numpy(
        np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32))
    small_match("sqp", SQP_EPISODE_TOL, lambda d: run_episodes_fused(
        AcrobotEnv, SQP(model=AcrobotEnv.model, T=10, max_iter=3), small_cfg, sqp_small.to(d),
        device=d))
    qp_small = torch.tensor([0.4, -0.3]).expand(8, -1) + 0.1 * torch.from_numpy(
        np.random.default_rng(6).standard_normal((8, 2)).astype(np.float32))
    for mode in ("goal", "state"):
        small_match(f"qpmpc admm at {mode}", QP_EPISODE_TOL, lambda d: run_episodes_fused(
            PendulumEnv, QPMPC(model=PendulumEnv.model, T=10, method="admm", iters=40,
                               linearize_at=mode), small_cfg, qp_small.to(d), device=d))

    i2c_small = torch.tensor([3.0, 0.2]).expand(8, -1) + 0.1 * torch.from_numpy(
        np.random.default_rng(7).standard_normal((8, 2)).astype(np.float32))
    small_match("i2c", I2C_EPISODE_TOL, lambda d: run_episodes_fused(
        PendulumEnv, I2C(model=PendulumEnv.model, T=10, max_iter=3), small_cfg,
        i2c_small.to(d), device=d))

    # swing-up progress on the kernel tier (the reference's own check)
    penv = PendulumEnv
    psolver = MPPI(model=penv.model, T=15, K=16, std=1.0, lam=1.0)
    pres = run_episodes_fused(
        penv, psolver, EpisodeConfig(n_steps=40, warmstart=20, record_plans=False),
        penv.start_state(dev).expand(16, -1).contiguous(),
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    c = pres.costs.cpu()
    if not (torch.isfinite(c).all() and c[:, -10:].mean() < 0.75 * c[:, :10].mean()):
        fail(f"pendulum swing-up made no progress: early {float(c[:, :10].mean()):.3f}, "
             f"late {float(c[:, -10:].mean()):.3f}")
    print(f"swing-up progress: early {float(c[:, :10].mean()):.3f} -> "
          f"late {float(c[:, -10:].mean()):.3f}", flush=True)

    # 5. timings at the main paths' shapes, with each bound from this run's shapes
    model = env.model
    S, Z = model.state_size, model.goal_size
    ms, dev_ms, plain_ms, bounds, chains = {}, {}, {}, {}, {}

    def time_kernel(name, fn):
        """Around one call (the table's column) and device time; the
        difference is the wrapper's host work before its launch."""
        ms[name], dev_ms[name] = cuda_time_ms(fn), device_time_ms(fn)

    # kernels 1, 2 and 3, each beside its instruction-issue floor: the
    # rollout loop's fast-path SASS instructions per trip (a warp's step of a
    # sample a lane, or of a rollout a thread) over every trip of the call,
    # at one warp instruction per cycle on each of an SM's four schedulers.
    # Kernel 1 at the bench shape (the kernels line) and the sweep's MPPI
    # row, kernel 2 at the MPPI (the kernels line) and CEM two-stage shapes
    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    loops = {src: sass_loop(_build._target(src), src) for src in SASS_LOOPS}
    issue, other_shapes = {}, {}

    def issue_line(name, label, src, trips, around_ms, device_ms, bnd, cfg):
        """Prints a kernel's times beside its bound and issue floor; returns
        the floor in ms (None where the loop was not counted)."""
        counted = loops[src]
        floor = None if counted is None else counted[0] * trips / (sms * 4 * clock * 1e3)
        what = ("instruction-issue floor not measured (no cuobjdump, or no rollout loop found "
                "in its output)" if counted is None else
                f"the rollout loop issues {counted[0]} SASS instructions a trip on its fast path "
                f"({counted[1]} in its body; cuobjdump), {trips} warp trips: instruction-issue "
                f"floor {floor:.4f} ms at {sms} SMs x 4 schedulers x {clock:.0f} MHz")
        print(f"[{smi}] {name} at {label}: around one call {around_ms:.4f} ms, device "
              f"{device_ms:.4f} ms; {what}, beside the bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"launch {cfg}", flush=True)
        return floor

    def mppi_bound(B, K, T):
        return bound(4 * (2 * T * B + S * B + T * Z),
                     B * K * T * (NOISE_OPS + STEP_OPS[model.name] + PASS1_EXTRA + PASS2_EXTRA)
                     + B * K * MPPI_WEIGHT_OPS)

    def rollout_bound(N, T):
        return bound(4 * (S * N + T * N + T * Z + N), N * T * STEP_OPS[model.name])

    plan, x0, gz = mppi_inputs(model, BATCH, HORIZON, 1, dev)
    lanes = pick_lanes(BATCH)
    time_kernel("fused_mppi_step",
                lambda: fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7))
    plain_ms["fused_mppi_step"] = cuda_time_ms(lambda: fused_mppi_step_reference(
        model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7), reps=3, warmup=1)
    bounds["fused_mppi_step"] = mppi_bound(BATCH, K_SAMPLES, HORIZON)
    issue["fused_mppi_step"] = issue_line(
        "fused_mppi_step", f"the bench shape (cart-pole, B={BATCH}, K={K_SAMPLES}, T={HORIZON})",
        "fused_mppi.cu", BATCH * -(-K_SAMPLES // 32) * HORIZON, ms["fused_mppi_step"],
        dev_ms["fused_mppi_step"], bounds["fused_mppi_step"],
        mppi_launch_config(model, HORIZON, K_SAMPLES, BATCH))

    N = BATCH * K_SAMPLES
    x0n = x0.repeat_interleave(K_SAMPLES, dim=1)
    usn = (plan.repeat_interleave(K_SAMPLES, dim=1)
           + torch.randn((HORIZON, N), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev))
    time_kernel("fused_rollout_costs_tm", lambda: fused_rollout_costs_tm(model, x0n, usn, gz))
    plain_ms["fused_rollout_costs_tm"] = cuda_time_ms(
        lambda: fused_rollout_costs_tm_reference(model, x0n, usn, gz), reps=3, warmup=1)
    bounds["fused_rollout_costs_tm"] = rollout_bound(N, HORIZON)
    issue["fused_rollout_costs_tm"] = issue_line(
        "fused_rollout_costs_tm", f"the MPPI two-stage shape (cart-pole, N={N}, T={HORIZON})",
        "fused_rollout.cu", -(-N // 32) * HORIZON, ms["fused_rollout_costs_tm"],
        dev_ms["fused_rollout_costs_tm"], bounds["fused_rollout_costs_tm"],
        rollout_launch_config(model, N))

    def other_shape(name, label, src, trips, fn, bnd, cfg):
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        floor = issue_line(name, label, src, trips, around, device, bnd, cfg)
        other_shapes.setdefault(name, []).append({
            "shape": label, "ms": around, "device_ms": device, "bound_ms": bnd[0],
            "bound_by": bnd[1], "issue_bound_ms": floor, "launch": cfg})

    plan, x0, gz = mppi_inputs(model, MPPI_SWEEP_B, HORIZON, 1, dev)
    lanes_s = pick_lanes(MPPI_SWEEP_B)
    other_shape("fused_mppi_step", f"the sweep's MPPI row (cart-pole, B={MPPI_SWEEP_B}, "
                f"K={MPPI_SWEEP_K}, T={HORIZON})", "fused_mppi.cu",
                MPPI_SWEEP_B * -(-MPPI_SWEEP_K // 32) * HORIZON,
                lambda: fused_mppi_step(model, MPPI_SWEEP_K, 1.0, 1.0, lanes_s, plan, x0, gz, 7),
                mppi_bound(MPPI_SWEEP_B, MPPI_SWEEP_K, HORIZON),
                mppi_launch_config(model, HORIZON, MPPI_SWEEP_K, MPPI_SWEEP_B))
    Nc = CEM_B * CEM_K
    rng = np.random.default_rng(4)
    x0c = torch.from_numpy(rng.uniform(-1, 1, (S, Nc)).astype(np.float32)).to(dev)
    usc = torch.from_numpy(rng.uniform(-1, 1, (CEM_T, Nc)).astype(np.float32)).to(dev)
    gzc = torch.zeros((CEM_T, Z), device=dev)
    other_shape("fused_rollout_costs_tm", f"the CEM two-stage shape (cart-pole, N={Nc}, "
                f"T={CEM_T})", "fused_rollout.cu", -(-Nc // 32) * CEM_T,
                lambda: fused_rollout_costs_tm(model, x0c, usc, gzc), rollout_bound(Nc, CEM_T),
                rollout_launch_config(model, Nc))
    del x0c, usc

    plan, x0, gz = mppi_inputs(model, CEM_B, CEM_T, 3, dev)
    cem_args = (model, CEM_K, CEM_ELITE, CEM_ITERS, 0.2, 1.0, pick_lanes(CEM_B), plan, x0, gz, 7)
    time_kernel("fused_cem_step", lambda: fused_cem_step(*cem_args))
    plain_ms["fused_cem_step"] = cuda_time_ms(lambda: fused_cem_step_reference(*cem_args),
                                              reps=3, warmup=1)
    cem_steps = CEM_B * CEM_K * CEM_T * CEM_ITERS
    bounds["fused_cem_step"] = bound(
        4 * (2 * CEM_T * CEM_B + S * CEM_B + CEM_T * Z),
        cem_steps * (NOISE_OPS + STEP_OPS[model.name] + CEM_SAMPLE_OPS)
        + CEM_B * CEM_ITERS * (CEM_ELITE * CEM_T * CEM_MOMENT_OPS + CEM_T * CEM_UPDATE_OPS
                               + CEM_K * CEM_ELITE * CEM_SELECT_OPS))
    print(f"fused_cem_step: {cem_steps} rollout steps per launch", flush=True)
    issue["fused_cem_step"] = issue_line(
        "fused_cem_step", "the sweep's shape", "fused_cem.cu",
        CEM_B * -(-CEM_K // 32) * CEM_T * CEM_ITERS, ms["fused_cem_step"],
        dev_ms["fused_cem_step"], bounds["fused_cem_step"],
        cem_launch_config(model, CEM_T, CEM_K, CEM_B))

    # kernel 5 at iLQR's shape (cart-pole derivatives, check_pd) and at SQP's
    # (acrobot, with_c, mu = 0); the bound with the horizon's chain beside
    # the bytes' and operations'
    d = riccati_main
    time_kernel("riccati_backward_batch", lambda: riccati_backward_batch(*d, ones))
    plain_ms["riccati_backward_batch"] = cuda_time_ms(
        lambda: riccati_backward_batch_reference(*d, ones), reps=3, warmup=1)
    per_t = S + 1 + S * S + 1 + S + S * S + S  # l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u
    riccati_bytes = 4 * ILQR_B * (ILQR_T * (per_t + 1 + S) + S + S * S + 2)
    bounds["riccati_backward_batch"] = bound(riccati_bytes, ILQR_B * ILQR_T * riccati_ops(S))
    chains["riccati_backward_batch"] = chain_ms(ILQR_T, riccati_chain(S), clock)
    with_chain = bound(riccati_bytes, ILQR_B * ILQR_T * riccati_ops(S),
                       chains["riccati_backward_batch"])
    print(f"[{smi}] riccati_backward_batch at iLQR's shape (cart-pole, B={ILQR_B}, T={ILQR_T}, "
          f"S={S}): around one call {ms['riccati_backward_batch']:.4f} ms, device "
          f"{dev_ms['riccati_backward_batch']:.4f} ms; bound {bounds['riccati_backward_batch'][0]:.5f}"
          f" ms ({bounds['riccati_backward_batch'][1]}), with the chain ({riccati_chain(S)} "
          f"dependent operations a step at {clock:.0f} MHz) {with_chain[0]:.5f} ms "
          f"({with_chain[1]})", flush=True)
    fn = lambda: riccati_backward_batch(*sq[:8], sq[8], check_pd=False, with_c=True)  # noqa: E731
    print(f"[{smi}] riccati_backward_batch at SQP's shape (acrobot, with_c, mu = 0, B={SQP_B}, "
          f"T={SQP_T}): around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms; chain {chain_ms(SQP_T, riccati_chain(4, True), clock):.5f}"
          f" ms", flush=True)

    # kernel 6 at iLQR's shape (cart-pole, with_terminal) and at SQP's
    # (acrobot, n_alpha=8, with_terminal and return_states); the bound with
    # the horizon's chain beside the bytes' and operations'
    acro = AcrobotEnv.model
    ls_in = ls_inputs_for(model, ILQR_B, ILQR_T, 8, dev)
    time_kernel("fused_linesearch",
                lambda: fused_linesearch(model, alphas, *ls_in, with_terminal=True))
    plain_ms["fused_linesearch"] = cuda_time_ms(
        lambda: fused_linesearch_reference(model, alphas, *ls_in, with_terminal=True),
        reps=3, warmup=1)
    ls_steps = N_ALPHAS * ILQR_B * ILQR_T
    ls_bytes = 4 * (2 * ILQR_B * ILQR_T * (1 + S) + ILQR_B * S + N_ALPHAS + ILQR_T * Z
                    + N_ALPHAS * ILQR_B * (ILQR_T + 1))
    bounds["fused_linesearch"] = bound(ls_bytes, ls_steps * (STEP_OPS[model.name] + LS_EXTRA(S)))
    chains["fused_linesearch"] = chain_ms(ILQR_T, linesearch_chain(model.name), clock)
    cfg_ls = ls_launch_config(model, N_ALPHAS, ILQR_B)
    print(f"[{smi}] fused_linesearch at iLQR's shape (cart-pole, n_a={N_ALPHAS}, B={ILQR_B}, "
          f"T={ILQR_T}, terminal): around one call {ms['fused_linesearch']:.4f} ms, device "
          f"{dev_ms['fused_linesearch']:.4f} ms; bound {bounds['fused_linesearch'][0]:.5f} ms "
          f"({bounds['fused_linesearch'][1]}), chain ({linesearch_chain(model.name)} dependent "
          f"operations a step at {clock:.0f} MHz) {chains['fused_linesearch']:.5f} ms; launch "
          f"{cfg_ls}", flush=True)
    ls_sqp = ls_inputs_for(acro, SQP_B, SQP_T, 9, dev)
    fn = lambda: fused_linesearch(acro, sqp_alphas, *ls_sqp, with_terminal=True,  # noqa: E731
                                  return_states=True)
    print(f"[{smi}] fused_linesearch at SQP's shape (acrobot, n_a={len(sqp_alphas)}, B={SQP_B}, "
          f"T={SQP_T}, terminal, states): around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms; chain ({linesearch_chain(acro.name)} dependent "
          f"operations a step) {chain_ms(SQP_T, linesearch_chain(acro.name), clock):.5f} ms; "
          f"launch {ls_launch_config(acro, len(sqp_alphas), SQP_B)}", flush=True)

    # kernel 4 at SQP's shape and model (acrobot), kernel 7 at configuration 1's
    dv_in = derivs_inputs(acro, SQP_B, SQP_T, 9, True)
    time_kernel("fused_derivs", lambda: fused_derivs(acro, *dv_in))
    plain_ms["fused_derivs"] = cuda_time_ms(lambda: fused_derivs_reference(acro, *dv_in),
                                            reps=3, warmup=1)
    Sa = acro.state_size
    pts = SQP_B * SQP_T
    bounds["fused_derivs"] = bound(
        4 * (pts * (Sa + 1) + SQP_T * (Sa + 1) + pts * (2 * Sa * Sa + 4 * Sa + 2)),
        pts * derivs_ops(acro))
    print(f"fused_derivs: {derivs_ops(acro)} operations per acrobot point, {pts} points",
          flush=True)
    dv_cart = derivs_inputs(model, ILQR_B, ILQR_T, 9, True)
    fn = lambda: fused_derivs(model, *dv_cart)  # noqa: E731
    print(f"[{smi}] fused_derivs on cart-pole (the Gauss-Newton iLQR path), B={ILQR_B}, "
          f"T={ILQR_T}: around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms", flush=True)

    # kernel 7 at configuration 1's shape (the kernels line), per problem at
    # n=50 and past the shared-memory form at n=300 (other_shapes); the bound
    # with the iterations' chain beside the bytes' and operations'
    def admm_bound(B, n, iters, per_problem):
        return bound(4 * ((B if per_problem else 1) * n * n + 2 * B * n + 2 * n),
                     B * iters * n * ADMM_ROW_OPS(n))

    time_kernel("admm_iterate", lambda: admm_iterate(*admm_main, iters=QP1_ITERS))
    plain_ms["admm_iterate"] = cuda_time_ms(
        lambda: admm_iterate_reference(*admm_main, iters=QP1_ITERS), reps=3, warmup=1)
    bounds["admm_iterate"] = admm_bound(QP1_B, QP1_T, QP1_ITERS, False)
    chains["admm_iterate"] = chain_ms(QP1_ITERS, admm_chain(QP1_T), clock)
    print(f"[{smi}] admm_iterate at configuration 1's shape (shared, n={QP1_T}, B={QP1_B}, "
          f"{QP1_ITERS} iterations): around one call {ms['admm_iterate']:.4f} ms, device "
          f"{dev_ms['admm_iterate']:.4f} ms; bound {bounds['admm_iterate'][0]:.5f} ms "
          f"({bounds['admm_iterate'][1]}), chain ({admm_chain(QP1_T)} dependent operations an "
          f"iteration at {clock:.0f} MHz) {chains['admm_iterate']:.5f} ms; launch "
          f"{admm_launch_config(QP1_B, QP1_T, False)}", flush=True)
    for label, args, iters, chain in (
            ("per problem, n=50, B=256, 60 iterations", random_qps(256, 50, True, False, 13), 60,
             chain_ms(60, admm_chain(50), clock)),
            (f"shared, n={ADMM_BIG_N}, B={ADMM_BIG_B}, {ADMM_BIG_ITERS} iterations (streaming)",
             random_qps(ADMM_BIG_B, ADMM_BIG_N, False, False, 25), ADMM_BIG_ITERS, None)):
        B_, n_ = args[1].shape
        fn = lambda a=args, k=iters: admm_iterate(*a, iters=k)  # noqa: E731
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        bnd, launch = admm_bound(B_, n_, iters, args[0].ndim == 3), admm_launch_config(
            B_, n_, args[0].ndim == 3)
        plain = cuda_time_ms(lambda a=args, k=iters: admm_iterate_reference(*a, iters=k),
                             reps=3, warmup=1)
        print(f"[{smi}] admm_iterate {label}: around one call {around:.4f} ms, device "
              f"{device:.4f} ms, plain {plain:.3f} ms; bound {bnd[0]:.5f} ms ({bnd[1]})"
              f"{'' if chain is None else f', chain {chain:.5f} ms'}; launch {launch}", flush=True)
        other_shapes.setdefault("admm_iterate", []).append({
            "shape": label, "ms": around, "device_ms": device, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "chain_bound_ms": chain, "launch": launch})

    # kernels 8a and 8b on a first iteration's matrices: cart-pole at the
    # sweep's shape (the table's row), then the pendulum at configuration 6's.
    # Each bound is the bytes' and the operations' (the kernels line's) and,
    # beside it, the larger with the horizon's loop-carried chain

    def i2c_bounds(p):
        B_, T_, D = p[0].shape[:3]
        Zf = p[2].shape[2]
        pts = B_ * T_
        shared = 2 * D * D + T_ * Zf + p[4].numel() + B_ * D  # sig0, Qproc, g_z, R, mu0
        work = ((4 * (pts * (D * D + D + Zf * D + Zf + 2 * (D + D * D)) + shared),
                 pts * i2c_filter_ops(D, Zf), chain_ms(T_, i2c_filter_chain(D, Zf), clock)),
                (4 * (pts * (2 * (D + D * D) + D * D + D)), pts * i2c_rts_ops(D),
                 chain_ms(T_ - 1, i2c_rts_chain(D), clock)))
        return [bound(b_, o_) for b_, o_, _ in work], [bound(*w) for w in work]

    def i2c_line(label, p, outs, times, plain):
        two, three = i2c_bounds(p)
        D, Zf = p[0].shape[2], p[2].shape[2]
        for i, name in enumerate(("i2c_filter", "i2c_rts_smooth")):
            chain = i2c_filter_chain(D, Zf) if i == 0 else i2c_rts_chain(D)
            print(f"[{smi}] {name} at {label}: kernel {times[i]:.4f} ms, plain {plain[i]:.3f} ms, "
                  f"bound {two[i][0]:.5f} ms ({two[i][1]}); with the chain ({chain} dependent "
                  f"operations a step at {clock:.0f} MHz) {three[i][0]:.5f} ms ({three[i][1]}), "
                  f"{100 * three[i][0] / times[i]:.1f} % of it", flush=True)
        return two

    p, outs = i2c_first_iteration_inputs["cartpole_swingup"]
    time_kernel("i2c_filter", lambda: i2c_filter(*p))
    time_kernel("i2c_rts_smooth", lambda: i2c_rts_smooth(*outs, p[0]))
    chains["i2c_filter"] = chain_ms(I2CS_T, i2c_filter_chain(5, 5), clock)
    chains["i2c_rts_smooth"] = chain_ms(I2CS_T - 1, i2c_rts_chain(5), clock)
    plain_ms["i2c_filter"] = cuda_time_ms(lambda: i2c_filter_reference(*p), reps=3, warmup=1)
    plain_ms["i2c_rts_smooth"] = cuda_time_ms(lambda: i2c_rts_smooth_reference(*outs, p[0]),
                                              reps=3, warmup=1)
    bounds["i2c_filter"], bounds["i2c_rts_smooth"] = i2c_line(
        f"the sweep's shape (cart-pole, B={I2CS_B}, T={I2CS_T}, D=Z=5)", p, outs,
        (ms["i2c_filter"], ms["i2c_rts_smooth"]), (plain_ms["i2c_filter"], plain_ms["i2c_rts_smooth"]))
    print(f"i2c_filter: {i2c_filter_ops(5, 5)} operations per point at D = Z = 5, "
          f"i2c_rts_smooth: {i2c_rts_ops(5)}; {I2CS_B * I2CS_T} points", flush=True)
    p6, outs6 = i2c_first_iteration_inputs["pendulum"]
    fns6 = (lambda: i2c_filter(*p6), lambda: i2c_rts_smooth(*outs6, p6[0]))
    i2c_line(f"configuration 6's shape (pendulum, B={I2C6_B}, T={I2C6_T}, D=Z=3)", p6, outs6,
             [cuda_time_ms(f) for f in fns6],
             (cuda_time_ms(lambda: i2c_filter_reference(*p6), reps=3, warmup=1),
              cuda_time_ms(lambda: i2c_rts_smooth_reference(*outs6, p6[0]), reps=3, warmup=1)))
    print(f"[{smi}] i2c_filter and i2c_rts_smooth at configuration 6's shape: device "
          f"{device_time_ms(fns6[0]):.4f} and {device_time_ms(fns6[1]):.4f} ms", flush=True)

    for name in ms:
        print(f"[{smi}] {name}: around one call {ms[name]:.4f} ms, device {dev_ms[name]:.4f} ms "
              f"(the wrapper's host work before its launch {ms[name] - dev_ms[name]:.4f} ms), "
              f"plain {plain_ms[name]:.3f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]})",
              flush=True)

    ep = {
        "mppi kernel tier": report_episodes(smi, "mppi kernel tier", episode_seconds(
            mppi_episode, 12), BATCH, N_STEPS),
        "mppi two-stage tier": report_episodes(smi, "mppi two-stage tier", episode_seconds(
            lambda: mppi_episode(False), 6), BATCH, N_STEPS),
        "cem kernel tier": report_episodes(smi, "cem kernel tier", episode_seconds(
            cem_episode, 8), CEM_B, CEM_STEPS),
        "cem two-stage tier": report_episodes(smi, "cem two-stage tier", episode_seconds(
            lambda: cem_episode(False), 4), CEM_B, CEM_STEPS),
        "ilqr": report_episodes(smi, f"ilqr (warm start {ILQR_WARM} in the time)",
                                episode_seconds(ilqr_episode, 3, warmup=False),
                                ILQR_B, ILQR_STEPS),
        "ilqr gauss-newton": report_episodes(
            smi, f"ilqr gauss-newton (warm start {ILQR_WARM} in the time)",
            episode_seconds(ilqr_gn_episode, 3, warmup=False), ILQR_B, ILQR_STEPS),
        "sqp": report_episodes(smi, "sqp", episode_seconds(sqp_episode, 3, warmup=False),
                               SQP_B, SQP_STEPS),
        "qpmpc configuration 1": report_episodes(
            smi, "qpmpc configuration 1", episode_seconds(qp1_episode, 5), QP1_B, QP1_STEPS),
        "qpmpc configuration 2": report_episodes(
            smi, "qpmpc configuration 2", episode_seconds(qp2_episode, 3, warmup=False),
            QP2_B, QP2_STEPS),
        "i2c configuration 6": report_episodes(
            smi, "i2c configuration 6", episode_seconds(i2c6_episode, 3, warmup=False),
            I2C6_B, I2C6_STEPS),
        "i2c sweep row": report_episodes(
            smi, "i2c sweep row", episode_seconds(i2cs_episode, 3, warmup=False),
            I2CS_B, I2CS_STEPS),
    }

    profile_window("mppi kernel-tier episode", smi, mppi_episode)
    profile_window("mppi two-stage episode", smi, lambda: mppi_episode(False))
    profile_window("cem kernel-tier episode", smi, cem_episode)
    profile_window("cem two-stage episode", smi, lambda: cem_episode(False))
    gen = torch.Generator(device=dev).manual_seed(0)
    st = ilqr.init_state_batch(ILQR_B, gen, dev)
    gz = torch.zeros((ILQR_T, Z), device=dev)
    profile_window(f"ilqr solve (one MPC step, {ILQR_ITERS} iterations)", smi,
                   lambda: ilqr.solve_batch(st, ilqr_x0s, gz))
    qp1_st = qp1.init_state_batch(QP1_B, torch.Generator(device=dev).manual_seed(0), dev)
    qp1_gz = torch.zeros((QP1_T, PendulumEnv.model.goal_size), device=dev)
    profile_window("qpmpc configuration 1 solve (one MPC step)", smi,
                   lambda: qp1.solve_batch(qp1_st, qp1_x0s, qp1_gz))
    n_kernels = profile_window(f"sqp solve (one MPC step, {SQP_ITERS} iterations)", smi,
                               lambda: sqp.solve_batch(sqp_st, sqp_x0s, sqp_gz))
    if n_kernels:
        print(f"sqp solve: {n_kernels / SQP_ITERS:.0f} device kernels per iteration (the one "
              f"nominal rollout of the solve shared out over them)", flush=True)
    i2c6_st = i2c6.init_state_batch(I2C6_B, torch.Generator(device=dev).manual_seed(0), dev)
    i2c6_gz = torch.zeros((I2C6_T, PendulumEnv.model.goal_size), device=dev)
    for label, iters, solve in (
            ("configuration 6", I2C6_ITERS, lambda: i2c6.solve_batch(i2c6_st, i2c6_x0s, i2c6_gz)),
            ("sweep row", I2CS_ITERS, lambda: i2cs.solve_batch(i2cs_st, i2cs_x0s, i2cs_gz))):
        n_kernels = profile_window(f"i2c {label} solve (one MPC step, {iters} iterations)", smi,
                                   solve)
        if n_kernels:
            print(f"i2c {label} solve: {n_kernels / iters:.0f} device kernels per iteration",
                  flush=True)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s", flush=True)

    sources = {
        "fused_mppi_step": ("fused_mppi.cu", "benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:171"),
        "fused_rollout_costs_tm": ("fused_rollout.cu", "benchmarking_mpc_solvers_tpu/ops/fused.py:81"),
        "fused_cem_step": ("fused_cem.cu", "benchmarking_mpc_solvers_tpu/ops/fused_cem.py:111"),
        "riccati_backward_batch": ("riccati_backward.cu",
                                   "benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:107"),
        "fused_linesearch": ("fused_linesearch.cu",
                             "benchmarking_mpc_solvers_tpu/ops/fused_linesearch.py:122"),
        "fused_derivs": ("fused_derivs.cu", "benchmarking_mpc_solvers_tpu/ops/fused_derivs.py:86"),
        "admm_iterate": ("admm_iterate.cu", "benchmarking_mpc_solvers_tpu/ops/qp_pallas.py:148"),
        "i2c_filter": ("i2c_smooth.cu", "benchmarking_mpc_solvers_tpu/ops/i2c_pallas.py:121"),
        "i2c_rts_smooth": ("i2c_smooth.cu", "benchmarking_mpc_solvers_tpu/ops/i2c_pallas.py:239"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"benchmarking_mpc_solvers_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms[name], "device_ms": dev_ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "chain_bound_ms": chains.get(name), "issue_bound_ms": issue.get(name),
            "other_shapes": other_shapes.get(name, []), "library_ms": None, "pass": True})
    print(json.dumps({"kernels": kernels, "episode_ms": {k: v * 1e3 for k, v in ep.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
