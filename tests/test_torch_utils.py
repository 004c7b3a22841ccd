"""Port vs reference: the checkpoint, logging and timing utilities
(``utils/``).

- A checkpoint written by either package is read by the other, every leaf
  bit for bit: a dict with unsorted keys, an ``EpisodeResult`` with ``None``
  fields, a list and a tuple. The port numbers the leaves in JAX's order and
  writes JAX's treedef string.
- ``SweepCheckpoint`` files are exchanged between the packages.
- ``RunLogger`` writes the reference's jsonl records (the elapsed time
  ``t`` aside) and gives its series and summary for the same calls.
- ``Timer``, ``trace`` and the two device timers on the CPU, where they
  time the CPU: non-negative, ordered percentiles, and a step that does
  clearly more work reads longer.
"""

import json

import jax
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.experiment.episode import EpisodeResult as JResult
from benchmarking_mpc_solvers_tpu.utils import checkpoint as jckpt
from benchmarking_mpc_solvers_tpu.utils import logging as jlog
from benchmarking_mpc_solvers_tpu_torch.experiment.episode import EpisodeResult as TResult
from benchmarking_mpc_solvers_tpu_torch.utils import checkpoint as tckpt
from benchmarking_mpc_solvers_tpu_torch.utils import logging as tlog
from benchmarking_mpc_solvers_tpu_torch.utils import profiling as tprof


def _arrays(seed):
    """The leaves' values: float32, int64 and bool arrays of several shapes,
    NaN and infinities included."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((3, 4)).astype(np.float32)
    f[0, 0], f[1, 1], f[2, 2] = np.nan, np.inf, -0.0
    return [f, rng.integers(-9, 9, (5,)).astype(np.int64), rng.random((2, 3)) > 0.5,
            rng.standard_normal((2,)).astype(np.float32), rng.standard_normal(()).astype(
                np.float32), rng.standard_normal((4, 1)).astype(np.float32),
            rng.standard_normal((6,)).astype(np.float32), np.arange(3, dtype=np.int32)]


def _tree(arrays, leaf, result_cls):
    """The same structure in either package's types; ``leaf`` wraps an
    array. Keys unsorted, a NamedTuple with None fields, a list, a tuple."""
    a = [leaf(x) for x in arrays]
    res = result_cls(a[0], a[1], a[2], a[3], a[4], a[5], None, None, None, None)
    return {"zeta": a[6], "alpha": [res, (a[7], None)], "mid": None}


def _leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_checkpoints_cross_read_bit_for_bit(tmp_path):
    arrays = _arrays(0)
    t_tree = _tree(arrays, torch.from_numpy, TResult)
    j_tree = _tree(arrays, jax.numpy.asarray, JResult)

    # the port writes, the reference reads
    tckpt.save_pytree(str(tmp_path / "port"), t_tree, meta={"step": 3})
    got = jckpt.load_pytree(str(tmp_path / "port"), j_tree)
    _leaves_equal(jax.tree.leaves(got), arrays[:6] + arrays[7:] + arrays[6:7])
    assert jckpt.load_meta(str(tmp_path / "port")) == {"step": 3}
    jckpt.save_pytree(str(tmp_path / "ref"), j_tree, meta={"step": 3})
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))

    # the reference writes, the port reads: tensors on the like tree's devices
    like = _tree([np.zeros_like(x) for x in arrays], torch.from_numpy, TResult)
    back = tckpt.load_pytree(str(tmp_path / "ref"), like)
    assert list(back) == list(like) and isinstance(back["alpha"][0], TResult)
    assert back["mid"] is None and back["alpha"][0].planned_states is None
    assert back["alpha"][1][1] is None
    leaves, _ = tckpt.flatten(back)
    assert all(torch.is_tensor(x) and x.device.type == "cpu" for x in leaves)
    _leaves_equal(leaves, jax.tree.leaves(j_tree))
    assert tckpt.load_meta(str(tmp_path / "ref")) == {"step": 3}


def test_checkpoint_refuses_another_structure(tmp_path):
    tckpt.save_pytree(str(tmp_path / "c"), {"a": torch.zeros(2), "b": [torch.ones(1)]})
    with pytest.raises(ValueError, match="2 leaves, expected 1"):
        tckpt.load_pytree(str(tmp_path / "c"), {"a": torch.zeros(2)})


def test_sweep_checkpoints_exchange(tmp_path):
    path = tmp_path / "sweep" / "done.json"
    t = tckpt.SweepCheckpoint(str(path))
    t.mark("mppi K=32")
    j = jckpt.SweepCheckpoint(str(path))
    assert j.is_done("mppi K=32") and not j.is_done("cem")
    j.mark("cem")
    t2 = tckpt.SweepCheckpoint(str(path))
    assert t2.done == {"mppi K=32", "cem"} and t2.is_done("cem")
    t2.mark("a")
    assert jckpt.SweepCheckpoint(str(path)).done == {"mppi K=32", "cem", "a"}


def test_run_logger_matches_reference(tmp_path, capsys):
    calls = [(0, {"cost": 1.5, "n": 3, "name": "x"}), (1, {"cost": 0.25, "n": 4}),
             (2, {"cost": 2.0, "extra": 7})]
    loggers = (tlog.RunLogger(str(tmp_path / "t" / "log.jsonl"), verbose=True, name="r"),
               jlog.RunLogger(str(tmp_path / "j" / "log.jsonl"), verbose=True, name="r"))
    printed = []
    for lg in loggers:
        for step, scalars in calls:
            lg.log(step, **scalars)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    recs = [[{k: v for k, v in json.loads(line).items() if k != "t"}
             for line in (tmp_path / d / "log.jsonl").read_text().splitlines()]
            for d in ("t", "j")]
    assert recs[0] == recs[1]
    for key in ("cost", "n", "name", "extra", "missing"):
        assert loggers[0].series(key) == loggers[1].series(key)
    assert loggers[0].summary() == loggers[1].summary()

    lg = tlog.RunLogger(verbose=False)
    lg.log(0, loss=torch.tensor(0.5))
    assert lg.series("loss") == [(0, 0.5)] and lg.summary() == {"loss_last": 0.5,
                                                                 "loss_mean": 0.5}


def test_timer_measures_a_block():
    import time

    with tprof.Timer("sleep") as t:
        time.sleep(0.02)
    assert t.name == "sleep" and 0.015 < t.elapsed < 1.0


def test_trace_writes_a_trace_file(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert log_dir == str(tmp_path / "tr") and path.exists()
    assert "traceEvents" in json.loads(path.read_text())


def _matmul_inputs(n):
    """A carry (n, n) and three per-step inputs (3, n, n)."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((n, n), generator=gen), torch.randn((3, n, n), generator=gen) / n


def test_device_timers_on_the_cpu():
    """On the CPU the timers time the CPU (no device number): non-negative,
    p50 <= p90, and a 384-wide matmul step reads longer than a 16-wide one."""
    kw = dict(samples=5, target_s=0.02, max_hi=16, return_stats=True, device="cpu")
    reads = {}
    for n in (16, 384):
        carry, xs = _matmul_inputs(n)
        reads[n] = tprof.device_step_latency(lambda c, x: (c, (c @ x)[0, 0]), carry, xs, **kw)
        p50, p90, res = reads[n]
        assert 0.0 <= p50 <= p90 and res >= 0.0
    assert reads[384][0] > reads[16][0]

    slopes = {}
    for n in (16, 384):
        def fn(gen, n=n):
            a = torch.randn((n, n), generator=gen)
            return (a @ a)[0, 0]
        slopes[n] = tprof.slope_timer(fn, generator=torch.Generator().manual_seed(1),
                                      inner_reps=5, outer_reps=2, device="cpu")
    assert slopes[384] > 0.0 and slopes[384] > slopes[16]
