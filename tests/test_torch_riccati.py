"""Port vs reference: the batched Riccati backward pass.

The port's plain version of the kernel is held against the JAX kernel run
in interpret mode and against ``jax.vmap(ILQR.backward_pass)``; the port's
own plain matrix-form ``ILQR.backward_pass`` against the latter too.
Tolerance rtol/atol 1e-5, the reference's own for its kernel against the
scan (tests/test_riccati_pallas.py): float32 in both, summed in other
orders; the random derivatives keep f_x's spectral radius below one so that
rounding differences do not grow over the horizon. ``ok`` is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import CartPoleSwingUpEnv, PendulumEnv
from benchmarking_mpc_solvers_tpu.ops.riccati_pallas import riccati_backward_batch as j_riccati
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu.solvers.ilqr import _Derivs
from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY as TMODELS
from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
    riccati_backward_batch,
    riccati_backward_batch_reference,
)
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR as TILQR
from benchmarking_mpc_solvers_tpu_torch.solvers.ilqr import Derivs

TOL = 1e-5
MU = np.array([0.0, 1e-3, 1.0, 32.0, 1024.0], np.float32)


def _derivs(B, T, S, seed, non_pd_row=None):
    """The reference test's random derivatives (tests/test_riccati_pallas.py),
    drawn with numpy; ``non_pd_row`` gets l_uu = -50 at one step."""
    rng = np.random.default_rng(seed)
    eye = np.eye(S, dtype=np.float32)
    sym = lambda m: 0.5 * (m + np.swapaxes(m, -1, -2))  # noqa: E731
    l_uu = 0.5 + rng.uniform(size=(B, T, 1, 1))
    if non_pd_row is not None:
        l_uu[non_pd_row, T // 2] = -50.0
    d = dict(
        l_x=rng.standard_normal((B, T + 1, S)),
        l_u=rng.standard_normal((B, T, 1)),
        l_xx=sym(rng.standard_normal((B, T + 1, S, S))) + 2.0 * eye,
        l_uu=l_uu,
        l_ux=rng.standard_normal((B, T, 1, S)),
        f_x=0.5 * eye + 0.1 * rng.standard_normal((B, T, S, S)),
        f_u=rng.standard_normal((B, T, S, 1)),
    )
    return {k: v.astype(np.float32) for k, v in d.items()}


def _jax_scan(d, mu, S):
    model = PendulumEnv.model if S == 2 else CartPoleSwingUpEnv.model
    solver = JILQR(model=model, T=d["l_u"].shape[1])
    with jax.default_matmul_precision("highest"):
        out = jax.vmap(lambda dd, m: JILQR.backward_pass(solver, dd, m))(
            _Derivs(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(mu))
    return [np.asarray(o) for o in out]


def _port(d, mu, **kw):
    return [o.numpy() for o in riccati_backward_batch(
        *(torch.tensor(v) for v in d.values()), torch.tensor(mu), **kw)]


@pytest.mark.parametrize("S", [2, 4])
def test_plain_matches_reference_kernel_and_scan(S):
    d = _derivs(5, 10, S, seed=S)
    want_k = j_riccati(*(jnp.asarray(v) for v in d.values()), jnp.asarray(MU), interpret=True)
    want_s = _jax_scan(d, MU, S)
    got = _port(d, MU)
    for want in (want_k, want_s):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_non_pd_step_flags_only_its_scenario():
    d = _derivs(3, 6, 4, seed=1, non_pd_row=1)
    mu = np.zeros((3,), np.float32)
    want = _jax_scan(d, mu, 4)
    got = _port(d, mu)
    assert got[2].tolist() == [True, False, True]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)


def test_with_c_matches_reference_kernel():
    """The TV-LQR form (SQP's): mu = 0, no PD check, affine residual c."""
    B, T, S = 4, 8, 4
    d = _derivs(B, T, S, seed=2)
    c = (0.3 * np.random.default_rng(9).standard_normal((B, T, S))).astype(np.float32)
    mu = np.zeros((B,), np.float32)
    want = j_riccati(*(jnp.asarray(v) for v in d.values()), jnp.asarray(mu), c=jnp.asarray(c),
                     check_pd=False, with_c=True, interpret=True)
    got = _port(d, mu, c=torch.tensor(c), check_pd=False, with_c=True)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL, atol=TOL)


def test_ilqr_matrix_backward_pass_matches_reference_scan():
    d = _derivs(5, 10, 4, seed=4, non_pd_row=3)
    want = _jax_scan(d, MU, 4)
    solver = TILQR(model=TMODELS["cartpole_swingup"], T=10)
    got = solver.backward_pass(Derivs(**{k: torch.tensor(v) for k, v in d.items()}),
                               torch.tensor(MU))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_plain_versions_agree_and_wrapper_checks_shapes():
    d = {k: torch.tensor(v) for k, v in _derivs(3, 5, 4, seed=5).items()}
    mu = torch.tensor([0.5, 1.0, 2.0])
    before = riccati_backward_batch.launches
    a = riccati_backward_batch(*d.values(), mu)
    b = riccati_backward_batch_reference(*d.values(), mu)
    assert riccati_backward_batch.launches == before  # CPU: no kernel launch
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        riccati_backward_batch(*list(d.values())[:-1], d["f_u"][:, :-1], mu)
