"""Batched scalar-action Riccati backward pass in one launch.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:
riccati_backward_batch``. On CUDA tensors ``riccati_backward_batch``
launches the hand-written kernel in ``csrc/riccati_backward.cu`` (at S <= 4
a lane per entry of V_xx, rows exchanged by warp shuffles, the horizon's
inputs staged in shared memory ahead of the recursion); on CPU tensors it
runs ``riccati_backward_batch_reference``, the plain PyTorch version with
the reference kernel's arithmetic written out element by element in the
same order. ``riccati_backward_batch.launches`` counts kernel launches.

Semantics (the reference kernel's, ``solvers/ilqr.py:ILQR.backward_pass``
for a scalar action):
- μ enters the gain solve only: q_uu + μ·Σf_u² and q_ux + μ·f_uᵀf_x;
- the value recursion is unregularised, and V_xx is symmetrised each step;
- with ``check_pd`` a step whose regularised q_uu is not > 0 divides by 1
  and the recursion carries on; ``ok`` is the product over all t;
- with ``with_c`` the Q-terms contract V_x + V_xx·c (the TV-LQR residual).
"""

from __future__ import annotations

import torch

from .. import _build

MAX_STATE = 8  # the kernel's largest state size (a template parameter)


def pallas_riccati_applicable(state_size: int, action_size: int) -> bool:
    """Shape gate of the solvers' dispatch to ``riccati_backward_batch``
    (the reference's name, kept for its callers)."""
    return action_size == 1 and state_size <= MAX_STATE


_NAMES = ("l_u", "l_xx", "l_uu", "l_ux", "f_x", "f_u", "mu", "c")


def _check_shapes(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c, with_c):
    B, Tp1, S = l_x.shape
    T = Tp1 - 1
    want = ((B, T, 1), (B, T + 1, S, S), (B, T, 1, 1), (B, T, 1, S), (B, T, S, S),
            (B, T, S, 1), (B,), (B, T, S) if with_c else None)
    for key, t, shape in zip(_NAMES, (l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c), want):
        if shape is not None and (t is None or t.shape != shape):
            raise ValueError(f"riccati_backward_batch: {key} has shape "
                             f"{None if t is None else tuple(t.shape)}, expected {shape}")
    return B, T, S


def riccati_backward_batch_reference(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c=None,
                                     check_pd: bool = True, with_c: bool = False):
    """Plain version over the batch: the horizon as a loop, every matrix
    entry a (B,) tensor, each sum in the reference kernel's order."""
    B, Tp1, S = l_x.shape
    T = Tp1 - 1
    rs = range(S)
    vx = [l_x[:, T, i] for i in rs]
    vxx = [[l_xx[:, T, i, j] for j in rs] for i in rs]
    ok = torch.ones((B,), dtype=torch.float32, device=l_x.device)
    ks = [None] * T
    Ks = [None] * T
    for t in reversed(range(T)):
        fx = [[f_x[:, t, i, j] for j in rs] for i in rs]
        fu = [f_u[:, t, i, 0] for i in rs]
        if with_c:
            vxc = [vx[i] + sum(vxx[i][k] * c[:, t, k] for k in rs) for i in rs]
        else:
            vxc = vx
        q_x = [l_x[:, t, j] + sum(fx[i][j] * vxc[i] for i in rs) for j in rs]
        q_u = l_u[:, t, 0] + sum(fu[i] * vxc[i] for i in rs)
        m = [[sum(vxx[i][k] * fx[k][j] for k in rs) for j in rs] for i in rs]
        q_xx = [[l_xx[:, t, j, jp] + sum(fx[i][j] * m[i][jp] for i in rs) for jp in rs]
                for j in rs]
        w = [sum(vxx[i][k] * fu[k] for k in rs) for i in rs]
        q_uu = l_uu[:, t, 0, 0] + sum(fu[i] * w[i] for i in rs)
        q_ux = [l_ux[:, t, 0, j] + sum(fu[i] * m[i][j] for i in rs) for j in rs]
        fufu = sum(fu[i] * fu[i] for i in rs)
        q_uu_r = q_uu + mu * fufu
        q_ux_r = [q_ux[j] + mu * sum(fu[i] * fx[i][j] for i in rs) for j in rs]
        if check_pd:
            pd = q_uu_r > 0.0
            ok = ok * pd.to(torch.float32)
            inv = 1.0 / torch.where(pd, q_uu_r, torch.ones_like(q_uu_r))
        else:
            inv = 1.0 / q_uu_r
        k = -q_u * inv
        K = [-q_ux_r[j] * inv for j in rs]
        vx = [q_x[j] + K[j] * (q_uu * k + q_u) + q_ux[j] * k for j in rs]
        vnew = [[q_xx[j][jp] + K[j] * q_uu * K[jp] + K[j] * q_ux[jp] + q_ux[j] * K[jp]
                 for jp in rs] for j in rs]
        vxx = [[0.5 * (vnew[j][jp] + vnew[jp][j]) for jp in rs] for j in rs]
        ks[t] = k
        Ks[t] = torch.stack(K, dim=-1)
    ks = torch.stack(ks, dim=1)[..., None]  # (B, T, 1)
    Ks = torch.stack(Ks, dim=1)[:, :, None, :]  # (B, T, 1, S)
    return ks, Ks, ok > 0.5


def riccati_backward_batch(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c=None,
                           check_pd: bool = True, with_c: bool = False):
    """Batched backward Riccati recursion, batch-first as the reference:
    l_x (B, T+1, S), l_u (B, T, 1), l_xx (B, T+1, S, S), l_uu (B, T, 1, 1),
    l_ux (B, T, 1, S), f_x (B, T, S, S), f_u (B, T, S, 1), mu (B,), c
    (B, T, S) with ``with_c`` -> (ks (B, T, 1), Ks (B, T, 1, S), ok (B,)
    bool). The kernel on CUDA tensors, the plain version on CPU tensors."""
    B, T, S = _check_shapes(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c, with_c)
    if S > MAX_STATE:
        raise NotImplementedError(f"state_size {S} > {MAX_STATE}")
    if l_x.device.type == "cpu":
        return riccati_backward_batch_reference(l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c,
                                                check_pd, with_c)
    if l_x.device.type != "cuda":
        raise ValueError(f"unsupported device {l_x.device}")
    dev = l_x.device
    args = (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu) + ((c,) if with_c else ())
    _build.check_cuda_args("riccati_backward_batch", dev,
                           **dict(zip(("l_x",) + _NAMES, args)))
    # ks and Ks split one allocation; the kernel writes ok as the bools returned
    ks, Ks = torch.empty(B * T * (S + 1), dtype=torch.float32, device=dev).split(
        [B * T, B * T * S])
    ks, Ks = ks.view(B, T, 1), Ks.view(B, T, 1, S)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0 or T == 0:
        return ks, Ks, ok.fill_(True)
    rc = _build.kernel_fn("riccati_backward_batch_launch")(
        *(t.data_ptr() for t in args[:8]), c.data_ptr() if with_c else None,
        ks.data_ptr(), Ks.data_ptr(), ok.data_ptr(), B, T, S, int(check_pd),
        _build.stream_ptr(dev))
    _build.check_rc("riccati_backward_batch", rc)
    riccati_backward_batch.launches += 1
    return ks, Ks, ok


riccati_backward_batch.launches = 0


def tvlqr_backward_cv(dyn, cost):
    """Batched drop-in for ``ops.riccati.tvlqr_backward(dyn, cost, reg=0.0)``
    through ``riccati_backward_batch`` (the reference's ``custom_vmap``
    dispatcher of the same name): dyn and cost carry one leading batch
    dimension, (q, qf) and (Q, Qf) are packed into l_x and l_xx, μ = 0, no
    PD check, and the affine residual c enters the Q-terms. Scalar action
    only (callers gate on ``pallas_riccati_applicable``)."""
    from .riccati import TVLQRPolicy

    B = dyn.A.shape[0]
    l_x = torch.cat([cost.q, cost.qf[:, None]], dim=1)  # (B, T+1, S)
    l_xx = torch.cat([cost.Q, cost.Qf[:, None]], dim=1)  # (B, T+1, S, S)
    mu = torch.zeros((B,), dtype=torch.float32, device=dyn.A.device)
    ks, Ks, _ok = riccati_backward_batch(
        l_x, cost.r.contiguous(), l_xx, cost.R.contiguous(), cost.M.contiguous(),
        dyn.A.contiguous(), dyn.B.contiguous(), mu, c=dyn.c.contiguous(),
        check_pd=False, with_c=True)
    return TVLQRPolicy(Ks, ks)
