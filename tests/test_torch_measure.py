"""The measurement scripts of the port (``benchmarking_mpc_solvers_tpu_torch/
scripts/``: roofline, profile_cem, profile_ilqr, profile_sqp, profile_i2c,
bench_riccati, scaling_bench) and the roofline kernels' plain versions,
against the JAX package on the CPU.

- Kernel 9's plain version (``ops/roofline.py:roofline_op_reference``)
  against the JAX script's kernel (``scripts/roofline.py:88-94``) rebuilt
  here with ``pl.pallas_call(..., interpret=True)``, its TPU memory spaces
  included (they run in interpret mode on the CPU): rtol 1e-6, a few ulps
  of the chain (XLA's CPU code and PyTorch's round the libm calls apart by
  an ulp, and the chains here contract); fma 4e-6, as XLA's CPU code fuses
  x·a + b into one rounding where the port (and its kernel, built with
  --fmad=false) rounds twice, up to an ulp a step over 16 steps; log also
  atol 2.4e-7, two ulps of the 1 + |x| it rounds: a one-ulp difference in x
  can round that sum to its neighbour, 1.2e-7 apart, once the chain has
  brought x down to ~0.1.
- Kernel 10's plain version against ``ops/fused_mppi.py:interp_normals``
  summed over the iterations, and for the paired form r·sin built from the
  same hash bits: atol 1e-5.
- Each script's ``--quick --device cpu`` run returns the JAX script's record
  and stage keys (a CPU run: none of its times is a device measurement).
- bench_riccati's two Riccati forms against the JAX package's at T=8, and
  scaling_bench on a 2-device CPU mesh.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarking_mpc_solvers_tpu.ops import fused_mppi as jfm
from benchmarking_mpc_solvers_tpu.ops import riccati as jric
from benchmarking_mpc_solvers_tpu.ops.linearize import AffineDynamics as JDyn
from benchmarking_mpc_solvers_tpu.ops.linearize import QuadCost as JCost
from benchmarking_mpc_solvers_tpu_torch.ops import riccati as tric
from benchmarking_mpc_solvers_tpu_torch.ops.roofline import (
    OPS, roofline_noise, roofline_noise_reference, roofline_op, roofline_op_reference)
from benchmarking_mpc_solvers_tpu_torch.scripts import (
    bench_riccati, profile_cem, profile_i2c, profile_ilqr, profile_sqp, roofline, scaling_bench)

# the JAX script's rows (scripts/roofline.py:186-202)
JAX_OPS = {
    "fma": lambda x: x * 1.000001 + 1e-7,
    "cos": jnp.cos,
    "sin": jnp.sin,
    "log": lambda x: jnp.log(jnp.abs(x) + 1.0),
    "div": lambda x: 0.731 / (x + 1.0),
    "exp": lambda x: jnp.exp(-jnp.abs(x)),
}


def jax_roofline_kernel(op, inner, grid, lanes=512):
    """``scripts/roofline.py:measure_pallas_op``'s kernel, in interpret mode."""
    def kernel(x_ref, o_ref):
        o_ref[:] = lax.fori_loop(0, inner, lambda i, x: op(x), x_ref[:])

    spec = pl.BlockSpec((1, 8, lanes), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return jax.jit(pl.pallas_call(
        kernel, grid=(grid,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((grid, 8, lanes), jnp.float32), interpret=True))


OP_RTOL, OP_ATOL = {"fma": 4e-6}, {"log": 2.4e-7}


@pytest.mark.parametrize("op", OPS)
def test_roofline_op_plain_matches_the_jax_kernel(op):
    x = np.random.default_rng(0).uniform(0.1, 1.5, (2, 8, 512)).astype(np.float32)
    want = np.asarray(jax_roofline_kernel(JAX_OPS[op], 16, 2)(x))
    got = roofline_op(op, torch.from_numpy(x), 16)  # a CPU tensor: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_RTOL.get(op, 1e-6),
                               atol=OP_ATOL.get(op, 0.0))
    assert torch.equal(got, roofline_op_reference(op, torch.from_numpy(x), 16))


def _jax_noise_sum(seed_c, inner, paired):
    """interp_normals' draws summed over i < inner; paired adds r·sin from
    the same hash bits (the hash written out as in ops/fused_mppi.py:98-127,
    its cosine half checked against interp_normals itself)."""
    lanes, acc = 512, 0.0
    idx = (lax.broadcasted_iota(jnp.uint32, (16, lanes), 0) * jnp.uint32(lanes)
           + lax.broadcasted_iota(jnp.uint32, (16, lanes), 1))
    for i in range(inner):
        x = (jnp.asarray(seed_c, jnp.uint32) * jnp.uint32(0x9E3779B9)
             + jnp.uint32(i) * jnp.uint32(0x85EBCA6B) + idx)
        x ^= x >> 16
        x *= jnp.uint32(0x7FEB352D)
        x ^= x >> 15
        x *= jnp.uint32(0x846CA68B)
        x ^= x >> 16
        u = (x >> 8).astype(jnp.float32) * (1.0 / (1 << 24))
        r = jnp.sqrt(-2.0 * jnp.log(u[:8] + 1e-7))
        ang = 2.0 * jnp.float32(np.pi) * u[8:]
        cos_half = jfm.interp_normals(seed_c, i, lanes)
        np.testing.assert_array_equal(np.asarray(r * jnp.cos(ang)), np.asarray(cos_half))
        acc = acc + cos_half
        if paired:
            acc = acc + r * jnp.sin(ang)
    return np.asarray(acc)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_roofline_noise_plain_matches_interp_normals(seed, paired):
    s = torch.tensor([seed], dtype=torch.int32)
    got = roofline_noise(s, 1024, 4, paired)  # a CPU tensor: the plain version
    assert got.shape == (1024, 8, 512)
    for g in (0, 1, 1023):
        want = _jax_noise_sum(np.uint32((seed + g) % 2**32), 4, paired)
        np.testing.assert_allclose(got[g].numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got[:2], roofline_noise_reference(s, 2, 4, paired))


def test_roofline_wrappers_refuse_bad_arguments():
    with pytest.raises(ValueError, match="unknown op"):
        roofline_op("tan", torch.zeros(4), 2)
    with pytest.raises(TypeError, match="int32"):
        roofline_noise(torch.tensor([7]), 2, 2)


# the JAX scripts' record and stage keys, by script
ROOFLINE_ROWS = {
    "fma": {"what", "elem_evals_per_s", "approx_flops_per_s", "inner", "elems", "paired_dt_s"},
    "pallas_cos": {"what", "elem_evals_per_s", "paired_dt_s"},
    "pallas_noise": {"what", "normals_per_s", "paired_dt_s"},
    "hbm": {"what", "bytes_moved", "paired_dt_s", "GB_per_s"},
}
STAGES = {
    profile_cem: {"noise_draw", "noise+fused_rollout_score", "topk+elite_mask"},
    profile_ilqr: {"rollout", "derivatives", "backward_scan", "backward_pallas",
                   "forward_x10_scan", "forward_x10_fused", "solve_x5iter"},
    profile_sqp: {"rollout", "linearize", "quadratize", "subproblem(lin+quad+riccati)",
                  "subproblem+linesearch", "solve_x6iter_B4"},
    profile_i2c: {"rollout", "linearize", "smooth_iter_pallas", "smooth_iter_scan",
                  "solve_x10iter_pallas", "solve_x10iter_scan"},
}


def _quick(mod, tmp_path, *extra):
    return mod.main(["--quick", "--device", "cpu", "--results-dir", str(tmp_path), *extra])


def test_roofline_quick_run_has_the_jax_records(tmp_path):
    out = _quick(roofline, tmp_path)
    assert set(out) == {"device", "fma", "cos", "log", "div", "exp", "pallas_cos", "pallas_sin",
                        "pallas_log", "pallas_noise", "pallas_noise_paired", "hbm"}
    assert out["device"]["platform"] == "cpu"
    for key in ("fma", "cos", "log", "div", "exp"):
        assert set(out[key]) == ROOFLINE_ROWS["fma"]
    for key in ("pallas_cos", "pallas_sin", "pallas_log"):
        assert set(out[key]) == ROOFLINE_ROWS["pallas_cos"]
    for key in ("pallas_noise", "pallas_noise_paired"):
        assert set(out[key]) == ROOFLINE_ROWS["pallas_noise"]
    assert set(out["hbm"]) == ROOFLINE_ROWS["hbm"]
    assert (tmp_path / "measure" / "roofline.json").exists()


@pytest.mark.parametrize("mod", sorted(STAGES, key=lambda m: m.__name__),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_profile_quick_run_has_the_jax_stages(mod, tmp_path):
    out = _quick(mod, tmp_path)
    assert STAGES[mod] <= set(out["stage_ms"]), sorted(out["stage_ms"])
    for rec in out["stage_ms"].values():
        assert {"p50_ms", "p90_ms"} <= set(rec) and rec["p50_ms"] >= 0.0
    assert "config" in out and out["device"]["platform"] == "cpu"
    if mod is profile_cem:
        for label in ("episodes_vmapped_scalar", "episodes_fused_solve_batch",
                      "episodes_single_kernel"):
            assert set(out[label]) == {"wall_s_per_call", "solves_per_s"}
    name = mod.__name__.rsplit(".", 1)[1]
    assert (tmp_path / "measure" / f"{name}.json").exists()


def test_bench_riccati_quick_run_has_the_jax_lines(tmp_path):
    out = _quick(bench_riccati, tmp_path)
    benches = [(r["bench"], r["T"], r.get("B")) for r in out["lines"]]
    assert benches == [("tvlqr_backward", 5, None), ("admm_solve_riccati_batch", 5, 1),
                       ("admm_solve_riccati_batch", 5, 4), ("tvlqr_backward", 10, None),
                       ("admm_solve_riccati_batch", 10, 1), ("admm_solve_riccati_batch", 10, 4)]
    for r in out["lines"]:
        assert {"seq_us", "assoc_us", "parallel_speedup"} <= set(r)


def test_bench_riccati_forms_match_the_jax_package():
    """The bench's problem (double integrator, random linear terms from
    numpy) through both Riccati forms of each package at T=8."""
    T = 8
    rng = np.random.default_rng(1)
    q, r = (0.1 * rng.standard_normal((T, 2))).astype(np.float32), \
        (0.1 * rng.standard_normal((T, 1))).astype(np.float32)
    dyn, Q, R, Qf = bench_riccati.double_integrator(T, "cpu")
    cost = bench_riccati.cost_for(T, Q, R, Qf, torch.from_numpy(q), torch.from_numpy(r))
    jd = JDyn(*(jnp.asarray(t.numpy()) for t in dyn))
    jc = JCost(*(jnp.asarray(t.numpy()) for t in cost))
    for tfn, jfn in ((tric.tvlqr_backward, jric.tvlqr_backward),
                     (tric.tvlqr_backward_assoc, jric.tvlqr_backward_assoc)):
        got, want = tfn(dyn, cost), jfn(jd, jc)
        np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-5, atol=1e-5)


def test_scaling_bench_on_a_two_device_cpu_mesh(tmp_path):
    out = _quick(scaling_bench, tmp_path, "--devices", "2")
    lines = out["lines"]
    assert [r["devices"] for r in lines] == [1, 2] and [r["batch"] for r in lines] == [8, 16]
    for r in lines:
        assert {"solves_per_sec", "weak_scaling_efficiency",
                "partition_overhead_vs_1dev_same_work", "note"} <= set(r)
        assert r["finite"] and r["solves_per_sec"] > 0
