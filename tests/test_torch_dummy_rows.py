"""The forms of the rollout-cost kernel's dummy form (kernel 2 past S = 8).

``ops/fused.py:dummy_plan`` picks, on the host, the form a dummy launch of
kernel 2 takes: the rows form (the state in registers, the weights as kernel
parameters, the goals staged in shared memory a chunk of steps at a time)
where the cost's list is every state square, each followed or not by its
action term, then the action's square or not, and S fits the widest row;
else the list form. Held here on the CPU:
- the form and row width the plan gives by weights and S, and the rows'
  weights (``dummy_rows``: -0.0 past S);
- that the term list ``kernel_ab.py`` hands a build without the rows form
  (``rows_terms``) is the cost's own (``_build.dummy_terms``);
- that a float32 evaluation in the rows form's order (every compiled row,
  the padded ones adding -0.0 * (+0 * +0), each row's action term after its
  square, the action's square last, then the clip) is the JAX package's
  ``quad_cost`` bit for bit, saturating, infinite, NaN and negative-zero
  inputs included (the JAX cost is called eagerly, one operation at a time).
The kernel itself is held to the plain version bit for bit on the card, and
the chunk of goals and the shared bytes its entry points pick are read there
through ``launch_config`` (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase (m)).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import kernel_ab
from benchmarking_mpc_solvers_tpu.models.base import quad_cost as jquad_cost
from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost as tquad_cost
from benchmarking_mpc_solvers_tpu_torch.ops.fused import DUMMY_ROWS, dummy_plan, dummy_rows
from test_torch_dummy_split import _same_bits, _weights

# (weights, S, form, row, acts): the identity's squares at the narrowest
# row that holds S; past the widest row and under off-diagonal state terms
# (dense) the list form; the mid-list's (8, S) and the off-square's
# (S - 1, S) are action terms after their row's square; without the
# action's square (no action) the rows form all the same
PLANS = [("identity", 9, "rows", 12, False), ("identity", 12, "rows", 12, False),
         ("identity", 13, "rows", 16, False), ("identity", 16, "rows", 16, False),
         ("identity", 17, "rows", 20, False), ("identity", 21, "rows", 24, False),
         ("identity", 25, "rows", 28, False), ("identity", 28, "rows", 28, False),
         ("identity", 31, "rows", 32, False), ("identity", 32, "rows", 32, False),
         ("identity", 33, "list", 0, False), ("identity", 64, "list", 0, False),
         ("identity", 160, "list", 0, False), ("dense", 12, "list", 0, False),
         ("dense", 20, "list", 0, False), ("dense", 71, "list", 0, False),
         ("midlist", 16, "rows", 16, True), ("midlist", 24, "rows", 24, True),
         ("noaction", 16, "rows", 16, False), ("offsquare", 16, "rows", 16, True),
         ("offsquare", 20, "rows", 20, True), ("offsquare", 28, "rows", 28, True),
         ("offsquare", 32, "rows", 32, True), ("midlist", 32, "rows", 32, True),
         ("noaction", 33, "list", 0, False)]


def _missing_square(S):
    """The identity without the square of state 3: not the rows form."""
    W = np.eye(S + 1, dtype=np.float32)
    W[3, 3] = 0.0
    return W


@pytest.mark.parametrize("name,S,form,row,acts", PLANS)
def test_dummy_plan_form(name, S, form, row, acts):
    plan = dummy_plan(tquad_cost(_weights(name, S)), S)
    assert (plan.form, plan.row, plan.acts) == (form, row, acts)


def test_dummy_plan_needs_every_state_square():
    """A state square left out, or an off-diagonal state term, is the
    list form's; so is a row width past ``DUMMY_ROWS``."""
    assert dummy_plan(tquad_cost(_missing_square(16)), 16).form == "list"
    W = np.eye(17, dtype=np.float32)
    W[2, 5] = W[5, 2] = 0.1
    assert dummy_plan(tquad_cost(W), 16).form == "list"
    assert dummy_plan(tquad_cost(np.eye(DUMMY_ROWS[-1] + 2, dtype=np.float32)),
                      DUMMY_ROWS[-1] + 1).form == "list"


@pytest.mark.parametrize("name,S", [("identity", 9), ("identity", 16), ("midlist", 16),
                                    ("noaction", 16), ("offsquare", 16), ("offsquare", 28),
                                    ("identity", 32)])
def test_rows_terms_are_the_cost_terms(name, S):
    """The term list ``kernel_ab.py`` gives a build without the rows form,
    from the rows' weights, is the cost's own list, bit for bit and in
    order."""
    cost = tquad_cost(_weights(name, S))
    want = _build.dummy_terms(cost, "cpu")[0].tolist()
    assert kernel_ab.rows_terms(dummy_rows(cost, S), S) == [tuple(t) for t in want]


@pytest.mark.parametrize("name,S", [("identity", 9), ("midlist", 16), ("offsquare", 16),
                                    ("noaction", 16), ("identity", 32)])
def test_dummy_rows_weights(name, S):
    """Each term's float32 weight where the kernel reads it, -0.0 in the
    padded rows; kept on the cost."""
    cost = tquad_cost(_weights(name, S))
    w = dummy_rows(cost, S)
    assert dummy_rows(cost, S) is w
    terms = {(i, j): np.float32(v) for i, j, v in cost.nz}
    for r in range(S):
        assert np.float32(w.d[r]) == terms[(r, r)]
        assert bool((w.acts >> r) & 1) == ((r, S) in terms)
        if (r, S) in terms:
            assert np.float32(w.a[r]) == terms[(r, S)]
    pad = np.array(w.d[S:], dtype=np.float32)
    assert (pad == 0).all() and np.signbit(pad).all()
    assert bool(w.square) == ((S, S) in terms)
    assert w.acts >> S == 0


def _rows_cost(w, row, x0, u, g):
    """Stage costs (B, T) in the rows form's order, numpy float32: the state
    padded with +0 to ``row`` entries, the goals likewise (the action's goal
    apart), each compiled row's square then its action term, the action's
    square, the clip."""
    S = x0.shape[1]
    x = np.zeros((x0.shape[0], row), np.float32)
    x[:, :S] = x0
    gp = np.zeros((g.shape[0], row), np.float32)
    gp[:, :S] = g[:, :S]
    za = u - g[None, :, S]
    c = np.zeros(u.shape, np.float32)
    for r in range(row):
        zr = x[:, None, r] - gp[None, :, r]
        c = c + np.float32(w.d[r]) * (zr * zr)
        if (w.acts >> r) & 1:
            c = c + np.float32(w.a[r]) * (zr * za)
    if w.square:
        c = c + np.float32(w.s) * (za * za)
    return np.clip(c, np.float32(-1e30), np.float32(1e30))


@pytest.mark.parametrize("name,S", [("identity", 9), ("identity", 16), ("identity", 31),
                                    ("midlist", 16), ("noaction", 16), ("offsquare", 16),
                                    ("offsquare", 29)])
def test_rows_cost_is_quad_cost_bit_for_bit(name, S):
    """The arithmetic of the rows form (a numpy copy of the kernel's order,
    not the kernel) keeps ``quad_cost``'s bits, its padded rows too."""
    W = _weights(name, S)
    cost = tquad_cost(W)
    plan = dummy_plan(cost, S)
    assert plan.form == "rows"
    w = dummy_rows(cost, S)
    rng = np.random.default_rng(S)
    B, T = 9, 7
    x0 = rng.uniform(-1.5, 1.5, (B, S)).astype(np.float32)
    u = rng.uniform(-2.0, 2.0, (B, T)).astype(np.float32)
    g = rng.uniform(-0.3, 0.3, (T, S + 1)).astype(np.float32)
    x0[1, 0] = 3e19  # saturates the sum at +1e30
    x0[2, S - 1] = -5e18
    u[3, :] = 4e19  # saturates the action's terms
    x0[4, S // 2] = np.nan
    u[5, 3] = np.nan
    x0[6, 1] = np.inf
    u[7, 2] = -np.inf
    x0[8, :] = -0.0  # negative zeros against goals of +0 and -0
    g[1, :] = -0.0
    g[2, :] = 0.0
    with np.errstate(all="ignore"):
        got = _rows_cost(w, plan.row, x0, u, g)
    z = np.concatenate([np.broadcast_to(x0[:, None, :], (B, T, S)), u[..., None]], axis=-1)
    want = np.asarray(jquad_cost(W)(jnp.asarray(z), jnp.asarray(g)))
    assert want.dtype == np.float32 and got.shape == want.shape
    assert np.isnan(want).any() and (np.abs(want) == np.float32(1e30)).any()
    _same_bits(got, want)
