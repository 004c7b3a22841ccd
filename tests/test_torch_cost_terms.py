"""The CUDA model functors against the registered models, on the CPU.

Kernels 1, 2, 3 and 6 compile the stage cost for the nonzero terms each
functor in ``csrc/models.cuh`` names (``kCostTerms``) and refuse any other
weights on the card. These tests read the header and hold each functor's
mask, the dispatch order and the feature bound against the Python side
(``_build.DEVICE_MODELS``, ``_build.MAX_Z``, ``_build.quad_weights``), so a
mask that disagrees with its model shows here and not first as a refused
launch.
"""

import re

import numpy as np
import pytest

from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY

HEADER = (_build.CSRC / "models.cuh").read_text()


def _dispatch():
    """Functor names by model id, from BMPC_DISPATCH_MODEL's cases."""
    cases = re.findall(r"case (\d+): \{ using M = bmpc::(\w+);", HEADER)
    return {int(i): name for i, name in cases}


def _cost_terms(functor: str) -> int:
    """The functor's kCostTerms, an OR of ``1u << bit`` terms."""
    body = re.search(rf"struct {functor} \{{(.*?)\n\}};", HEADER, re.S)
    assert body, functor
    expr = re.search(r"kCostTerms\s*=\s*([^;]*);", body.group(1))
    assert expr, functor
    terms = [t.strip() for t in expr.group(1).split("|")]
    bits = [re.fullmatch(r"1u\s*<<\s*(\d+)", t) for t in terms]
    assert all(bits), expr.group(1)
    return sum(1 << int(b.group(1)) for b in bits)


def test_dispatch_order_and_feature_bound_match_build():
    assert sorted(_dispatch()) == list(range(len(_build.DEVICE_MODELS)))
    assert int(re.search(r"constexpr int kMaxZ = (\d+);", HEADER).group(1)) == _build.MAX_Z


@pytest.mark.parametrize("name", _build.DEVICE_MODELS)
def test_functor_cost_terms_are_the_models_nonzero_weights(name):
    functor = _dispatch()[_build.DEVICE_MODELS.index(name)]
    w = _build.quad_weights(REGISTRY[name].state_cost)
    mask = sum(1 << i for i in range(_build.MAX_Z * _build.MAX_Z) if w[i] != 0.0)
    assert mask, name
    assert _cost_terms(functor) == mask, (name, functor)


def test_quad_weights_are_built_once_per_cost():
    cost = REGISTRY["cartpole_swingup"].state_cost
    w = _build.quad_weights(cost)
    assert _build.quad_weights(cost) is w
    assert all(w[i * _build.MAX_Z + j] == np.float32(v) for i, j, v in cost.nz)
