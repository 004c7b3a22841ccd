"""Port vs reference: the fused derivative stage (TPU kernel 4).

``fused_derivs`` on CPU tensors runs its plain version, which is held
against what the reference holds its Pallas kernel to
(tests/test_fused_derivs.py): ``vmap(linearize_dynamics)`` and
``vmap(quadratize_cost(gauss_newton=True))`` stage terms, on all three
models, at points on an action bound and, for the pendulum, on either side
of the angle wrap. The Pallas kernel itself is not run here: the reference
marks its interpret-mode test slow. The CUDA kernel is held against the
same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance rtol = atol = 1e-5, the reference's own for its kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.ops.linearize import linearize_dynamics, quadratize_cost
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import (
    fused_derivs,
    fused_derivs_reference,
)
from test_torch_linearize import B, NAMES, T, trajectories

TOL = 1e-5
OUT = ("A", "Bd", "c", "Q", "R", "M", "q", "r")


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_matches_the_reference_autodiff(name):
    xs, us, g_z = trajectories(name, seed=5)
    jm, tm = JENVS[name].model, TENVS[name].model
    dyn = jax.vmap(lambda x, u: linearize_dynamics(jm, x[:-1], u))(
        jnp.asarray(xs), jnp.asarray(us))
    cost = jax.vmap(lambda x, u: quadratize_cost(jm, x, u, jnp.asarray(g_z), gauss_newton=True))(
        jnp.asarray(xs), jnp.asarray(us))
    want = (dyn.A, dyn.B, dyn.c, cost.Q, cost.R, cost.M, cost.q, cost.r)
    before = fused_derivs.launches
    got = fused_derivs(tm, torch.tensor(xs), torch.tensor(us), torch.tensor(g_z))
    assert fused_derivs.launches == before  # no launch on the CPU
    S = tm.state_size
    shapes = ((B, T, S, S), (B, T, S, 1), (B, T, S), (B, T, S, S), (B, T, 1, 1), (B, T, 1, S),
              (B, T, S), (B, T, 1))
    for key, g, w, shape in zip(OUT, got, want, shapes):
        assert tuple(g.shape) == shape and g.dtype == torch.float32, key
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=key)


def test_clip_tangent_is_one_half_on_the_bound():
    """At u on the pendulum's torque bound the dynamics' clip passes half
    the tangent, as the reference's does; inside it passes all of it."""
    tm = TENVS["pendulum"].model
    xs = torch.zeros((1, 3, 2))
    us = torch.tensor([[[2.0], [0.5]]])
    _, Bd, *_ = fused_derivs_reference(tm, xs, us, torch.zeros((2, 3)))
    torch.testing.assert_close(Bd[0, :, 1, 0], torch.tensor([0.075, 0.15]))


def test_wrapper_checks_shapes_and_scope():
    import dataclasses

    tm = TENVS["pendulum"].model
    xs, us, gz = torch.zeros((2, 4, 2)), torch.zeros((2, 3, 1)), torch.zeros((3, 3))
    with pytest.raises(ValueError, match="xs has shape"):
        fused_derivs(tm, xs[:, :3], us, gz)
    with pytest.raises(ValueError, match="g_z has shape"):
        fused_derivs(tm, xs, us, gz.expand(2, 3, 3))  # a per-scenario goal
    wide = dataclasses.replace(tm, action_size=2)
    with pytest.raises(NotImplementedError, match="action_size == 1"):
        fused_derivs(wide, xs, us, gz)
