"""Port vs reference: the fused line search.

The port's plain version of the kernel is held against the JAX kernel run
in interpret mode, with and without the terminal cost and the returned
states, on all three models. Tolerances are the reference's own for its
kernel against the scan (tests/test_fused_linesearch.py): 1e-5 on controls
and states, 1e-4 on the costs, which sum T float32 stage costs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.ops.fused_linesearch import fused_linesearch as j_ls
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
    fused_linesearch,
    linesearch_applicable,
)
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR

ALPHAS = (1.1 ** (-np.arange(10, dtype=np.float32) ** 2)).astype(np.float32)


def _inputs(model, B, T, seed):
    rng = np.random.default_rng(seed)
    S = model.state_size
    arrays = (0.5 * rng.standard_normal((B, S)), 0.5 * rng.standard_normal((B, T, 1)),
              0.3 * rng.standard_normal((B, T, 1)), 0.2 * rng.standard_normal((B, T, 1, S)),
              0.3 * rng.standard_normal((B, T + 1, S)),
              rng.uniform(-0.2, 0.2, (T, model.goal_size)))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
@pytest.mark.parametrize("with_terminal,return_states", [
    (False, False), (False, True), (True, False), (True, True)])
def test_plain_matches_reference_kernel(name, with_terminal, return_states):
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    arrays = _inputs(jm, 6, 8, seed=len(name))
    want = j_ls(jm, jnp.asarray(ALPHAS), *(jnp.asarray(a) for a in arrays),
                with_terminal=with_terminal, return_states=return_states, interpret=True)
    got = fused_linesearch(tm, torch.tensor(ALPHAS), *(torch.tensor(a) for a in arrays),
                           with_terminal=with_terminal, return_states=return_states)
    assert len(got) == len(want) == (3 if return_states else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-4 if i == len(got) - 1 else 1e-5  # costs last
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_ilqr_forward_pass_matches_plain_kernel_version():
    """ILQR's plain matrix-form forward pass computes the same candidates."""
    tm = tmodels.CartPoleSwingUpModel
    x0, us, ks, Ks, xref, g_z = (torch.tensor(a) for a in _inputs(tm, 5, 7, seed=3))
    xref = torch.cat([x0[:, None], xref[:, 1:]], dim=1)  # the pass starts at xref[:, 0]
    solver = ILQR(model=tm, T=7, reference_accept=False)  # terminal cost in the objective
    xs_f, us_f, c_f = solver.forward_pass(torch.tensor(ALPHAS), ks, Ks, xref, us, g_z)
    us_k, xs_k, c_k = fused_linesearch(tm, torch.tensor(ALPHAS), x0, us, ks, Ks, xref, g_z,
                                       with_terminal=True, return_states=True)
    torch.testing.assert_close(us_f, us_k, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs_f, xs_k, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c_f, c_k, rtol=1e-4, atol=1e-4)


def test_applicability_gate():
    assert all(linesearch_applicable(m) for m in tmodels.REGISTRY.values())
    before = fused_linesearch.launches
    tm = tmodels.PendulumModel
    fused_linesearch(tm, torch.tensor(ALPHAS), *(torch.tensor(a) for a in _inputs(tm, 2, 3, 0)))
    assert fused_linesearch.launches == before  # CPU: the plain version
