"""The split of the dummy form's stage cost (kernels 1 and 3 past S = 8).

``quad_cost`` adds its nonzero terms one at a time from 0, over the upper
triangle row by row, and the dummy's action is its last feature S. So the
terms before the first that touches the action (the leading run,
``_build.dummy_terms``' ``n_lead``) do not depend on the action, and since the
dummy's state stays at x0 the kernels sum that run once per scenario and
step, then go on from the partial sum with the rest of the list (the tail)
at every sample. Held here on the CPU:
- the split ``_build.dummy_terms`` gives for the weights the card sees;
- that a float32 evaluation in the kernels' order (the leading run once per
  step, then the tail term by term, then the clip) is the JAX package's
  ``quad_cost`` bit for bit, saturating and NaN inputs included (the JAX
  cost is called eagerly, one operation at a time, so nothing contracts
  its multiply-adds).
The port's plain versions of kernels 1, 2 and 3 meet the JAX kernels on
these weights in ``test_torch_model_functors.py`` (``MODELS``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.models.base import quad_cost as jquad_cost
from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost as tquad_cost


def _weights(name, S):
    """The (S + 1, S + 1) weights of a case: the identity; ``dense``, the
    card's dense weights Wm @ Wm.T (every term nonzero, row 0 ends with the
    action); ``midlist``, the identity with a symmetric (8, S) term, so the
    tail holds state-only terms after an action term; ``noaction``, the
    identity without the action's square (no tail); ``offsquare``, the
    identity with its one action term moved to (S - 1, S)."""
    Z = S + 1
    if name == "dense":
        Wm = np.random.default_rng(12).uniform(-0.5, 1.0, (Z, Z)).astype(np.float32)
        return Wm @ Wm.T
    W = np.eye(Z, dtype=np.float32)
    if name == "midlist":
        W[8, S] = W[S, 8] = 0.3
    elif name in ("noaction", "offsquare"):
        W[S, S] = 0.0
    if name == "offsquare":
        W[S - 1, S] = W[S, S - 1] = 0.3
    return W


# (weights, S, n_lead, terms), the split counted by hand from the order of
# quad_cost: the identity's S squares lead and (S, S) is the tail; the dense
# weights' row 0 holds the S state terms before (0, S); the mid-list's rows 0
# to 8 lead with (8, 8), and (8, S), (9, 9) ... (15, 15), (S, S) follow; with
# no action term everything leads; the off-square's S squares lead and
# (S - 1, S) is the tail
SPLITS = [("identity", 9, 9, 10), ("identity", 16, 16, 17), ("identity", 31, 31, 32),
          ("dense", 12, 12, 91), ("midlist", 16, 9, 18), ("noaction", 16, 16, 16),
          ("offsquare", 16, 16, 17)]


@pytest.mark.parametrize("name,S,n_lead,n_terms", SPLITS)
def test_dummy_terms_split(name, S, n_lead, n_terms):
    cost = tquad_cost(_weights(name, S))
    terms, lead = _build.dummy_terms(cost, "cpu")
    assert (lead, terms.shape[0]) == (n_lead, n_terms)
    assert all(int(j) < S for j in terms[:lead, 1])
    assert lead == n_terms or int(terms[lead, 1]) == S
    again, lead_again = _build.dummy_terms(cost, torch.device("cpu"))
    assert again is terms and lead_again == lead  # kept on the cost


def _split_cost(nz, n_lead, S, x0, u, g):
    """Stage costs (B, K, T) in the kernels' order, numpy float32: the
    leading run summed once per (b, t) from 0, then each sample's tail term
    by term from that partial sum, then the clip to +-1e30."""
    zs = x0[:, None, :] - g[None, :, :S]  # (B, T, S) state features
    lead = np.zeros(zs.shape[:2], np.float32)
    for i, j, w in nz[:n_lead]:
        lead = lead + np.float32(w) * (zs[..., i] * zs[..., j])
    za = u - g[None, None, :, S]  # (B, K, T) the action's feature
    c = np.broadcast_to(lead[:, None, :], za.shape)
    for i, j, w in nz[n_lead:]:
        zi = za if i == S else zs[:, None, :, i]
        zj = za if j == S else zs[:, None, :, j]
        c = c + np.float32(w) * (zi * zj)
    return np.clip(c, np.float32(-1e30), np.float32(1e30))


def _same_bits(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("name,S", [(n, S) for n, S, _, _ in SPLITS])
def test_split_cost_is_quad_cost_bit_for_bit(name, S):
    """The arithmetic of the split (a numpy copy of the kernels' order, not
    the kernels: the card tests of ``test_torch_cuda.py`` and
    ``chip_smoke.py`` hold those to the plain versions bit for bit) keeps
    ``quad_cost``'s bits."""
    W = _weights(name, S)
    cost = tquad_cost(W)
    _, n_lead = _build.dummy_terms(cost, "cpu")
    rng = np.random.default_rng(S)
    B, K, T = 6, 5, 7
    x0 = rng.uniform(-1.5, 1.5, (B, S)).astype(np.float32)
    u = rng.uniform(-2.0, 2.0, (B, K, T)).astype(np.float32)
    g = rng.uniform(-0.3, 0.3, (T, S + 1)).astype(np.float32)
    x0[1, 0] = 3e19  # saturates the leading run at +1e30 (or -1e30 under negative terms)
    x0[2, S - 1] = -5e18
    u[3, 1, :] = 4e19  # saturates the action's terms
    u[3, 2, 2] = -1e25
    x0[4, S // 2] = np.nan
    u[5, 0, 3] = np.nan
    with np.errstate(all="ignore"):
        got = _split_cost(cost.nz, n_lead, S, x0, u, g)
    z = np.concatenate([np.broadcast_to(x0[:, None, None, :], (B, K, T, S)), u[..., None]],
                       axis=-1)
    want = np.asarray(jquad_cost(W)(jnp.asarray(z), jnp.asarray(g)))
    assert want.dtype == np.float32 and got.shape == want.shape
    assert np.isnan(want).any() and (np.abs(want) == np.float32(1e30)).any()
    _same_bits(got, want)
