"""The work of kernels 8a and 8b (I2C's Kalman filter and RTS smoother),
counted from the chain's shapes: B scenarios, T steps, the augmented
latent's size D = S + A and the features' Z.

A frozen copy of ``chip_smoke.py``'s ``i2c_work``, ``i2c_filter_ops`` and
``i2c_rts_ops``: each sum of n products counts 2n operations, each added
term 1, a Cholesky entry its multiply-subtracts and a square root or a
division, each diagonal one more for its floor. Bytes count each input
read once and each output written once: the filter reads F, m, J, z0 a
step and R, mu0, the priors and the goal once, and writes the filtered and
predicted means and covariances; the smoother reads those four and F and
writes the smoothed means.
"""

from __future__ import annotations


def chol_ops(n: int) -> int:
    """Operations of an n x n Cholesky factorisation."""
    return sum(2 * j + 1 for i in range(n) for j in range(i + 1)) + n


def filter_step_ops(D: int, Z: int) -> int:
    """Operations of one filter step."""
    return (D * Z * 2 * D                       # P J^T
            + Z * (Z + 1) // 2 * (2 * D + 1)    # lower triangle of sig_y
            + chol_ops(Z)
            + D * 2 * Z * Z                     # D pairs of triangular solves
            + Z * (2 * D + 2)                   # innovation
            + D * (2 * Z + 1)                   # mu_f
            + D * D * (2 * Z + 1) + 2 * D * D   # sig_f and its symmetrising
            + D * (2 * D + 1)                   # mu_pred
            + D * D * 2 * D + D * D * (2 * D + 1))  # F sig_f, sig_pred


def rts_step_ops(D: int) -> int:
    """Operations of one smoother step."""
    return (D * D * 2 * D + chol_ops(D) + D * 2 * D * D   # F sig_f, factor, D solves
            + D + D * (2 * D + 1)                         # mu_s
            + D * D + D * D * 2 * D + D * D * (2 * D + 1))  # sig_s


def filter_work(B: int, T: int, D: int, Z: int) -> tuple:
    """(bytes, operations) of one filter launch (kernel 8a)."""
    pts = B * T
    shared = 2 * D * D + T * Z + Z * Z + B * D  # sig0, Q, the goal, R, mu0
    return (4 * (pts * (D * D + D + Z * D + Z + 2 * (D + D * D)) + shared),
            pts * filter_step_ops(D, Z))


def rts_work(B: int, T: int, D: int) -> tuple:
    """(bytes, operations) of one smoother launch (kernel 8b)."""
    pts = B * T
    return 4 * pts * (2 * (D + D * D) + D * D + D), pts * rts_step_ops(D)
