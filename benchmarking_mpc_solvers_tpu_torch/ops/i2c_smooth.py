"""Batched Kalman filter and RTS smoother of the I2C solver, one launch each.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/i2c_pallas.py``. The I2C
iteration (``solvers/i2c.py``) is two passes over the horizon on small
matrices of the augmented latent ξ = (x, u), D = S + A, observed through the
cost features, Z of them:

- ``i2c_filter``: the time-varying Kalman filter, t = 0..T-1. Observation
  update with the gain from a Z×Z Cholesky solve of sig_y = J P Jᵀ + R, then
  the prediction F P Fᵀ + Q. Returns ``(mu_f, sig_f, mu_pred, sig_pred)``.
- ``i2c_rts_smooth``: the backward RTS pass over those four, with the gain
  G = P_f Fᵀ P_pred⁻¹ from a D×D Cholesky solve. Returns the smoothed means:
  T-1 smoothed rows, then the filtered mean of t = T-1.
- ``i2c_smooth_batch``: both, with the reference's arguments; T = 1 returns
  the filtered mean without a backward pass.

On CUDA tensors each wrapper launches its hand-written kernel in
``csrc/i2c_smooth.cu`` or raises; on CPU tensors it runs its
``*_reference``, the plain PyTorch version with the reference kernel's
arithmetic written out entry by entry in the same order, so that the kernel
and the plain version round alike. The kernels give each scenario a group of
8 lanes, lane r computing row r of each matrix (the Cholesky factor in every
lane), and copy the horizon's inputs into shared memory with ``cp.async`` a
few steps ahead of the chain; ``launch_config`` reports the launch shape.
``i2c_filter.launches`` and ``i2c_rts_smooth.launches`` count kernel
launches.

The Cholesky diagonals are floored at 1e-30 (the inputs are positive definite
by construction: R and the priors carry explicit ridges); a NaN passes the
floor and reaches the output, which the solver's failure guard relies on.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

MAX_DIM = 6  # the kernels' largest D and Z (template parameters)


def _chol(A, n):
    """Lower Cholesky factor of a symmetric matrix given as lists of (B,)
    tensors (its lower triangle is read); the diagonal floored at 1e-30."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))  # clamp keeps a NaN
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve(L, b, n):
    """x = (L Lᵀ)⁻¹ b by forward and backward substitution."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _stack_vec(rows):
    """[[(B,)] * n] * T -> (B, T, n)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)


def _stack_mat(rows):
    """[[[(B,)] * n] * n] * T -> (B, T, n, n)."""
    return torch.stack(
        [torch.stack([torch.stack(r, dim=-1) for r in mat], dim=-2) for mat in rows], dim=1)


def _check_filter_shapes(F, m, J, z0, R, mu0, sig0, Qproc, g_z):
    if F.ndim != 4 or J.ndim != 4:
        raise ValueError(f"i2c_filter: F {tuple(F.shape)} and J {tuple(J.shape)} must be "
                         f"(B, T, D, D) and (B, T, Z, D)")
    B, T, D, _ = F.shape
    Z = J.shape[2]
    if R.ndim not in (2, 3):
        raise ValueError(f"i2c_filter: R has shape {tuple(R.shape)}, expected (Z, Z) or "
                         f"(B, Z, Z)")
    want = {"F": (B, T, D, D), "m": (B, T, D), "J": (B, T, Z, D), "z0": (B, T, Z),
            "R": (Z, Z) if R.ndim == 2 else (B, Z, Z), "mu0": (B, D), "sig0": (D, D),
            "Qproc": (D, D), "g_z": (T, Z)}
    got = {"F": F, "m": m, "J": J, "z0": z0, "R": R, "mu0": mu0, "sig0": sig0,
           "Qproc": Qproc, "g_z": g_z}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"i2c_filter: {key} has shape {tuple(got[key].shape)}, "
                             f"expected {shape}")
    if T < 1:
        raise ValueError("i2c_filter: the horizon must hold at least one step")
    return B, T, D, Z


def _check_rts_shapes(mu_f, sig_f, mu_pred, sig_pred, F):
    if F.ndim != 4:
        raise ValueError(f"i2c_rts_smooth: F has shape {tuple(F.shape)}, expected (B, T, D, D)")
    B, T, D, _ = F.shape
    want = {"mu_f": (B, T, D), "sig_f": (B, T, D, D), "mu_pred": (B, T, D),
            "sig_pred": (B, T, D, D), "F": (B, T, D, D)}
    got = {"mu_f": mu_f, "sig_f": sig_f, "mu_pred": mu_pred, "sig_pred": sig_pred, "F": F}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"i2c_rts_smooth: {key} has shape {tuple(got[key].shape)}, "
                             f"expected {shape}")
    if T < 1:
        raise ValueError("i2c_rts_smooth: the horizon must hold at least one step")
    return B, T, D


def _check_dims(name: str, D: int, Z: int) -> None:
    if D > MAX_DIM or Z > MAX_DIM:
        raise NotImplementedError(
            f"{name}: the kernels hold D, Z <= {MAX_DIM}, got D = {D}, Z = {Z}; the solver's "
            f"solve_batch(use_fused=False) runs the plain per-step form")


# -- plain versions -----------------------------------------------------------------


def i2c_filter_reference(F, m, J, z0, R, mu0, sig0, Qproc, g_z):
    """Plain version of the forward filter: the horizon as a loop, every
    matrix entry a (B,) tensor, each sum in the reference kernel's order."""
    B, T, D, Z = _check_filter_shapes(F, m, J, z0, R, mu0, sig0, Qproc, g_z)
    rd, rz = range(D), range(Z)
    mu_p = [mu0[:, i] for i in rd]
    sig_p = [[sig0[i, j].expand(B) for j in rd] for i in rd]
    Rt = [[R[..., a, b] for b in rz] for a in rz]
    mu_fs, sig_fs, mu_ns, sig_ns = [], [], [], []
    for t in range(T):
        Jt = [[J[:, t, a, i] for i in rd] for a in rz]
        Ft = [[F[:, t, i, j] for j in rd] for i in rd]
        PJt = [[sum(sig_p[i][k] * Jt[a][k] for k in rd) for a in rz] for i in rd]
        sig_y = [[Rt[a][b] + sum(Jt[a][k] * PJt[k][b] for k in rd) for b in rz] for a in rz]
        Lc = _chol(sig_y, Z)
        sols = [_chol_solve(Lc, PJt[i], Z) for i in rd]
        innov = [g_z[t, a] - (sum(Jt[a][k] * mu_p[k] for k in rd) + z0[:, t, a]) for a in rz]
        mu_f = [mu_p[i] + sum(sols[i][a] * innov[a] for a in rz) for i in rd]
        sf = [[sig_p[i][j] - sum(sols[i][a] * PJt[j][a] for a in rz) for j in rd] for i in rd]
        sig_f = [[0.5 * (sf[i][j] + sf[j][i]) for j in rd] for i in rd]
        mu_p = [m[:, t, i] + sum(Ft[i][k] * mu_f[k] for k in rd) for i in rd]
        FS = [[sum(Ft[i][k] * sig_f[k][j] for k in rd) for j in rd] for i in rd]
        sig_p = [[sum(FS[i][k] * Ft[j][k] for k in rd) + Qproc[i, j] for j in rd] for i in rd]
        mu_fs.append(mu_f)
        sig_fs.append(sig_f)
        mu_ns.append(mu_p)
        sig_ns.append(sig_p)
    return _stack_vec(mu_fs), _stack_mat(sig_fs), _stack_vec(mu_ns), _stack_mat(sig_ns)


def i2c_rts_smooth_reference(mu_f, sig_f, mu_pred, sig_pred, F):
    """Plain version of the backward smoother over the filter's outputs."""
    B, T, D = _check_rts_shapes(mu_f, sig_f, mu_pred, sig_pred, F)
    rd = range(D)
    mu_next = [mu_f[:, T - 1, i] for i in rd]
    sig_next = [[sig_f[:, T - 1, i, j] for j in rd] for i in rd]
    out = [None] * T
    out[T - 1] = mu_next
    for t in reversed(range(T - 1)):
        sig_ft = [[sig_f[:, t, i, j] for j in rd] for i in rd]
        sig_pt = [[sig_pred[:, t, i, j] for j in rd] for i in rd]
        Ft = [[F[:, t, i, j] for j in rd] for i in rd]
        M = [[sum(Ft[i][k] * sig_ft[k][j] for k in rd) for j in rd] for i in rd]
        Lc = _chol(sig_pt, D)
        # G[i] solves sig_pred x = M[:, i]: G = (sig_pred⁻¹ M)ᵀ = sig_f Fᵀ sig_pred⁻¹
        G = [_chol_solve(Lc, [M[k][i] for k in rd], D) for i in rd]
        mu_sm = [mu_f[:, t, i] + sum(G[i][k] * (mu_next[k] - mu_pred[:, t, k]) for k in rd)
                 for i in rd]
        Dlt = [[sig_next[i][j] - sig_pt[i][j] for j in rd] for i in rd]
        GD = [[sum(G[i][k] * Dlt[k][j] for k in rd) for j in rd] for i in rd]
        sig_next = [[sig_ft[i][j] + sum(GD[i][k] * G[j][k] for k in rd) for j in rd]
                    for i in rd]
        mu_next = mu_sm
        out[t] = mu_sm
    return _stack_vec(out)


def i2c_smooth_batch_reference(F, m, J, z0, R, mu0, sig0, Qproc, g_z):
    """Plain version of ``i2c_smooth_batch``: smoothed means (B, T, D)."""
    mu_f, sig_f, mu_pred, sig_pred = i2c_filter_reference(F, m, J, z0, R, mu0, sig0, Qproc, g_z)
    if F.shape[1] == 1:
        return mu_f
    return i2c_rts_smooth_reference(mu_f, sig_f, mu_pred, sig_pred, F)


# -- wrappers -------------------------------------------------------------------------


def launch_config(D: int, Z: int, B: int) -> dict:
    """The kernels' launch shape for B scenarios at (D, Z) on the current
    card (the smoother's blocks are wider where B fills the SMs): the stages
    of the shared-memory ring and, for ``filter`` and ``rts`` each, threads
    and scenarios per block, time steps per stage, shared bytes per block,
    registers per thread and resident blocks per SM."""
    _check_dims("launch_config", D, Z)
    out = (ctypes.c_int * 13)()
    _build.check_rc("launch_config", _build.kernel_fn("i2c_launch_config")(
        D, Z, B, ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "scenarios_per_block", "chunk", "shared_bytes", "registers",
            "blocks_per_sm")
    return {"stages": out[0], "filter": dict(zip(keys, out[1:7])),
            "rts": dict(zip(keys, out[7:13]))}


def i2c_filter(F, m, J, z0, R, mu0, sig0, Qproc, g_z):
    """Forward Kalman filter for B scenarios: F (B, T, D, D), m (B, T, D),
    J (B, T, Z, D), z0 (B, T, Z), R (Z, Z) or (B, Z, Z), mu0 (B, D), sig0 and
    Qproc (D, D), g_z (T, Z) -> mu_f (B, T, D), sig_f (B, T, D, D) (after the
    update at t), mu_pred (B, T, D), sig_pred (B, T, D, D) (predicted for
    t+1). The kernel on CUDA tensors, the plain version on CPU tensors."""
    B, T, D, Z = _check_filter_shapes(F, m, J, z0, R, mu0, sig0, Qproc, g_z)
    if F.device.type == "cpu":
        return i2c_filter_reference(F, m, J, z0, R, mu0, sig0, Qproc, g_z)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    _check_dims("i2c_filter", D, Z)
    dev = F.device
    _build.check_cuda_args("i2c_filter", dev, F=F, m=m, J=J, z0=z0, R=R, mu0=mu0, sig0=sig0,
                           Qproc=Qproc, g_z=g_z)
    mu_f = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    sig_f = torch.empty((B, T, D, D), dtype=torch.float32, device=dev)
    mu_pred = torch.empty_like(mu_f)
    sig_pred = torch.empty_like(sig_f)
    if B == 0:
        return mu_f, sig_f, mu_pred, sig_pred
    rc = _build.kernel_fn("i2c_filter_launch")(
        *(_build.ptr(t) for t in (F, m, J, z0, R, mu0, sig0, Qproc, g_z,
                                  mu_f, sig_f, mu_pred, sig_pred)),
        B, T, D, Z, int(R.ndim == 3), _build.stream_ptr(dev))
    _build.check_rc("i2c_filter", rc)
    i2c_filter.launches += 1
    return mu_f, sig_f, mu_pred, sig_pred


i2c_filter.launches = 0


def i2c_rts_smooth(mu_f, sig_f, mu_pred, sig_pred, F):
    """Backward RTS smoother over the filter's outputs and F (B, T, D, D)
    (read for t <= T-2): smoothed means (B, T, D), the last row the filtered
    mean of t = T-1. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    B, T, D = _check_rts_shapes(mu_f, sig_f, mu_pred, sig_pred, F)
    if F.device.type == "cpu":
        return i2c_rts_smooth_reference(mu_f, sig_f, mu_pred, sig_pred, F)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    _check_dims("i2c_rts_smooth", D, D)
    dev = F.device
    _build.check_cuda_args("i2c_rts_smooth", dev, mu_f=mu_f, sig_f=sig_f, mu_pred=mu_pred,
                           sig_pred=sig_pred, F=F)
    mu_s = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    if B == 0:
        return mu_s
    rc = _build.kernel_fn("i2c_rts_launch")(
        *(_build.ptr(t) for t in (mu_f, sig_f, mu_pred, sig_pred, F, mu_s)),
        B, T, D, _build.stream_ptr(dev))
    _build.check_rc("i2c_rts_smooth", rc)
    i2c_rts_smooth.launches += 1
    return mu_s


i2c_rts_smooth.launches = 0


def i2c_smooth_batch(F, m, J, z0, R, mu0, sig0, Qproc, g_z):
    """Batched filter and smoother pass, the reference's arguments in its
    order: smoothed means (B, T, D). On CUDA tensors one launch of each
    kernel (the filter alone for T = 1)."""
    mu_f, sig_f, mu_pred, sig_pred = i2c_filter(F, m, J, z0, R, mu0, sig0, Qproc, g_z)
    if F.shape[1] == 1:
        return mu_f
    return i2c_rts_smooth(mu_f, sig_f, mu_pred, sig_pred, F)
