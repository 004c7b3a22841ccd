"""The work of the program's hand-written kernels, counted from the
algorithm's shapes and never from an implementation: the same work reads
the same whatever computes it.

A frozen copy of the counts the port's measurement script keeps beside its
kernels (one rollout step's FP32 operations per plant, counted by hand:
each add, multiply, divide, clamp compare and library call once; the
noise draw and the solvers' extras per sample), so that a roofline share
here does not move when the program's own counts do. Bytes count each
input read once and each output written once. ``least_time_s`` takes the
larger of the operations at the card's FP32 peak and the bytes at its
memory peak (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent

# the noise draw (two uniforms, +1e-7, log, -2*, sqrt, 2pi*, cos, r*) per
# (b, k, t); MPPI's extras per (b, k, t): pass 1 std*d, plan + sd and the
# control term, pass 2 w*(std*d) and its sum; per (b, k) the softmax (min,
# c - beta, /lam, exp, the weight sum, w/sum)
NOISE_OPS, PASS1_EXTRA, PASS2_EXTRA, MPPI_WEIGHT_OPS = 9, 5, 2, 6
# CEM: per (b, k, t, it) the sample mean + std*d and its clip; per (b,
# elite, t, it) the moments m1 += w*u, m2 += w*(u*u); per (b, t, it) the
# elite std and the two smoothings; per (b, k, round, it) the masked-min
# cost + sel*excl, the min and the tie test
CEM_SAMPLE_OPS, CEM_MOMENT_OPS, CEM_UPDATE_OPS, CEM_SELECT_OPS = 4, 5, 10, 4


def plant(name: str) -> dict:
    """A plant's state size S, feature size Z and rollout-step operations."""
    return json.loads((HERE / "plants" / f"{name}.json").read_text())


def peaks() -> dict:
    return json.loads((HERE.parent / "peaks.json").read_text())


def mppi_work(p: dict, B: int, K: int, T: int) -> tuple:
    """(bytes, operations) of one MPPI step for B scenarios (kernel 1)."""
    return (4 * (2 * T * B + p["S"] * B + T * p["Z"]),
            B * K * T * (NOISE_OPS + p["step_ops"] + PASS1_EXTRA + PASS2_EXTRA)
            + B * K * MPPI_WEIGHT_OPS)


def rollout_work(p: dict, N: int, T: int) -> tuple:
    """(bytes, operations) of N summed-cost rollouts of T steps (kernel 2)."""
    return 4 * (p["S"] * N + T * N + T * p["Z"] + N), N * T * p["step_ops"]


def cem_work(p: dict, B: int, K: int, T: int, n_elite: int, iters: int) -> tuple:
    """(bytes, operations) of one CEM solve for B scenarios (kernel 3)."""
    return (4 * (2 * T * B + p["S"] * B + T * p["Z"]),
            B * K * T * iters * (NOISE_OPS + p["step_ops"] + CEM_SAMPLE_OPS)
            + B * iters * (n_elite * T * CEM_MOMENT_OPS + T * CEM_UPDATE_OPS
                           + K * n_elite * CEM_SELECT_OPS))


def least_time_s(work: tuple, pk: dict = None) -> tuple:
    """(seconds, 'bytes' or 'operations'): the least time the card takes."""
    pk = pk or peaks()
    nbytes, ops = work
    b = {"bytes": nbytes / pk["hbm_bytes_per_s"], "operations": ops / pk["fp32_flops_per_s"]}
    bound = max(b, key=b.get)
    return b[bound], bound
