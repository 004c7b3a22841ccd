"""The CUDA model functors against the registered models, on the CPU.

Kernels 1, 2, 3 and 6 compile the stage cost for the nonzero terms each
plant's functor in ``csrc/models.cuh`` names (``kCostTerms``, a 64-bit mask
of ``term(i, j)`` bits over the upper triangle of kMaxZ = 9 features) and
take other weights in their generic form; the dummy family's functor
``Dummy<S>`` names none (past S = 8 kernels 1, 2 and 3 take the dummy in
a form whose weights are a term list). These tests read the header and hold each
functor's terms, the mask's bits, the dispatch order and the feature bound
against the Python side (``_build.DEVICE_MODELS``, ``_build.MAX_Z``,
``_build.quad_weights``), so a mask that disagrees with its model shows
here and not first as a slower launch on the card.
"""

import re

import numpy as np
import pytest

from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY

HEADER = (_build.CSRC / "models.cuh").read_text()


def _dispatch():
    """Functor names by model id, from BMPC_DISPATCH_MODEL's cases
    (``Dummy<S>`` as ``Dummy<S>``)."""
    cases = re.findall(r"case (\d+): \{ using M = bmpc::(\w+(?:<\d+>)?);", HEADER)
    return {int(i): name for i, name in cases}


def _cost_terms(functor: str) -> set:
    """The (i, j) terms of the functor's kCostTerms, an OR of ``term(i, j)``
    (none for ``kCostTerms = 0``)."""
    struct = functor.split("<")[0]
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", HEADER, re.S)
    assert body, functor
    expr = re.search(r"kCostTerms\s*=\s*([^;]*);", body.group(1))
    assert expr, functor
    if expr.group(1).strip() == "0":
        return set()
    terms = [re.fullmatch(r"term\((\d+), (\d+)\)", t.strip())
             for t in expr.group(1).split("|")]
    assert all(terms), expr.group(1)
    return {(int(t.group(1)), int(t.group(2))) for t in terms}


def _term_bit(i: int, j: int) -> int:
    """``bmpc::term_bit`` of the header, evaluated here (its division is
    exact: i (i - 1) is even)."""
    body = re.search(r"constexpr int term_bit\(int i, int j\) \{\s*return ([^;]*);", HEADER)
    assert body
    expr = body.group(1).replace("kMaxZ", str(_build.MAX_Z)).replace("/", "//")
    return eval(expr, {}, {"i": i, "j": j})


def test_dispatch_order_and_feature_bound_match_build():
    """The functors' dispatch and kMaxZ (the plants' and kernels 4 and 6's
    bound: the dummy's Z = S + 1 at S = 8) match ``_build``; past S = 8 the
    dummy needs no functor and no kMaxZ: kernels 1, 2 and 3 take it in their
    dummy form, whose weights are a term list in device memory
    (``dummy_cost``), through entry points of their own."""
    from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model

    dispatch = _dispatch()
    n = len(_build.DEVICE_MODELS) + len(_build.DUMMY_STATES)
    assert sorted(dispatch) == list(range(n))
    for S in _build.DUMMY_STATES:
        assert dispatch[_build.dummy_id(S)] == f"Dummy<{S}>", S
    assert int(re.search(r"constexpr int kMaxZ = (\d+);", HEADER).group(1)) == _build.MAX_Z
    assert _build.MAX_Z == _build.DUMMY_STATES[-1] + 1  # the dummy's Z = S + 1 at S = 8
    past = _build.DUMMY_STATES[-1] + 1
    assert _build.dummy_size(make_dummy_model(past, 1)) == past
    assert "__device__ __forceinline__ float dummy_cost(" in HEADER
    for src, entry in (("fused_mppi.cu", "fused_mppi_dummy_launch"),
                       ("fused_rollout.cu", "fused_rollout_dummy_launch"),
                       ("fused_cem.cu", "fused_cem_dummy_launch")):
        assert f'extern "C" int {entry}(' in (_build.CSRC / src).read_text(), entry
        assert _build.SIGNATURES[entry][0] == src


def test_cost_term_bits_are_distinct_and_fit_64():
    """Every term (i, j), i <= j < kMaxZ, has a bit of its own below 64: a
    reweighted plant's W_44 cannot alias a compiled term."""
    Z = _build.MAX_Z
    bits = [_term_bit(i, j) for i in range(Z) for j in range(i, Z)]
    assert sorted(bits) == list(range(Z * (Z + 1) // 2)) and max(bits) < 64


@pytest.mark.parametrize("name", _build.DEVICE_MODELS + ("dummy",))
def test_functor_cost_terms_are_the_models_nonzero_weights(name):
    """A plant's compiled terms are its registered weights' nonzero terms;
    the dummy family's functor compiles none (its weights, the identity for
    make_dummy_model, take the generic form)."""
    if name == "dummy":
        assert all(_cost_terms(_dispatch()[_build.dummy_id(S)]) == set()
                   for S in _build.DUMMY_STATES)
        # past S = 8 the dummy form contracts the weights' own terms, in order
        from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
        cost = make_dummy_model(_build.DUMMY_STATES[-1] + 1, 1).state_cost
        terms, _ = _build.dummy_terms(cost, "cpu")
        assert [(i, j) for i, j, _, _ in terms.tolist()] == [(i, j) for i, j, _ in cost.nz]
        return
    functor = _dispatch()[_build.DEVICE_MODELS.index(name)]
    w = _build.quad_weights(REGISTRY[name].state_cost)
    Z = _build.MAX_Z
    terms = {(i, j) for i in range(Z) for j in range(i, Z) if w[i * Z + j] != 0.0}
    assert terms, name
    assert _cost_terms(functor) == terms, (name, functor)


def test_quad_weights_are_built_once_per_cost():
    cost = REGISTRY["cartpole_swingup"].state_cost
    w = _build.quad_weights(cost)
    assert _build.quad_weights(cost) is w
    assert all(w[i * _build.MAX_Z + j] == np.float32(v) for i, j, v in cost.nz)
