"""Measured ceilings of the card: the rate of each operation the rollout
kernels lean on, of their noise stream, and of device memory.

Counterpart of ``scripts/roofline.py``, with its rows, shapes and record
keys:

- the element-wise rows (fma, cos, log(abs+add+log), div(add+div),
  exp(abs+neg+exp)) at shape (8, 524,288), each the op applied
  ``inner``·n times in a row to every element, n long against n short. The
  reference's XLA fuses each pass into one kernel; PyTorch would run a chain
  of eager operations through device memory, so here the chain runs in a
  register, through kernel 9 (``ops/roofline.py:roofline_op``);
- the kernel rows (cos, sin, log) at grid 256 × (8, 512), ``inner`` 2,048
  against 256, through kernel 9;
- the noise rows, single and paired, at grid 1,024 × (8, 512), ``inner``
  256 against 32, through kernel 10 (``roofline_noise``): the stream
  ``interp_normals`` kernels 1 and 3 draw (the TPU's hardware generator has
  no counterpart on the card);
- device-memory stream: 256 MB, 256 against 32 passes of an in-place
  multiply (one read and one write a pass).

Each time is the least of a few calls (CUDA events on the card), and each
rate comes from the long-against-short difference, so a call's constant
cost cancels. Prints one JSON line per row and writes
``<results-dir>/measure/roofline.json``.

    python -m benchmarking_mpc_solvers_tpu_torch.scripts.roofline            # the card
    python -m benchmarking_mpc_solvers_tpu_torch.scripts.roofline --quick --device cpu
"""

from __future__ import annotations

import json

import torch

from ..device import resolve_device
from ..ops.roofline import roofline_noise, roofline_op
from ._common import device_record, std_parser, wall_seconds, write_measure


def measure(op, name, chain, shape, device, ops_per_eval=1, reps=5):
    """Rate of ``op`` applied in a chain, ``chain`` = (inner, n_long,
    n_short): (n_long − n_short)·inner more applications to every element
    of a shape-sized tensor."""
    inner, n_long, n_short = chain
    print("measuring", name, flush=True)
    x = torch.full(shape, 0.731, dtype=torch.float32, device=device)
    dt = (wall_seconds(lambda: roofline_op(op, x, inner * n_long), device, reps)
          - wall_seconds(lambda: roofline_op(op, x, inner * n_short), device, reps))
    evals = x.numel() * inner * (n_long - n_short)
    rec = {"what": name, "elem_evals_per_s": evals / dt,
           "approx_flops_per_s": evals / dt * ops_per_eval, "inner": inner,
           "elems": x.numel(), "paired_dt_s": dt}
    print(json.dumps(rec), flush=True)
    return rec


def measure_kernel_op(op, name, device, inner_long=2048, inner_short=256, grid=256, lanes=512,
                      reps=8):
    """The reference's in-kernel rate: a grid of (8, lanes) tiles, each
    element with ``op`` applied ``inner`` times."""
    x = torch.full((grid, 8, lanes), 0.731, dtype=torch.float32, device=device)
    dt = (wall_seconds(lambda: roofline_op(op, x, inner_long), device, reps)
          - wall_seconds(lambda: roofline_op(op, x, inner_short), device, reps))
    evals = x.numel() * (inner_long - inner_short)
    rec = {"what": f"kernel_f32_{name}", "elem_evals_per_s": evals / dt, "paired_dt_s": dt}
    print(json.dumps(rec), flush=True)
    return rec


def measure_noise(device, inner_long=256, inner_short=32, paired=False, programs=1024,
                  reps=5):
    """Normals/s of the kernels' noise stream (kernel 10), single or
    paired."""
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    dt = (wall_seconds(lambda: roofline_noise(seed, programs, inner_long, paired), device, reps)
          - wall_seconds(lambda: roofline_noise(seed, programs, inner_short, paired), device,
                         reps))
    evals = 8 * 512 * programs * (2 if paired else 1) * (inner_long - inner_short)
    rec = {"what": "box_muller_normals" + ("_paired" if paired else ""),
           "normals_per_s": evals / dt, "paired_dt_s": dt}
    print(json.dumps(rec), flush=True)
    return rec


def measure_hbm(device, n_mb=256, n_long=256, n_short=32, reps=5):
    """Device-memory stream rate: passes of an in-place multiply over
    n_mb MB, one read and one write of the array a pass."""
    n = n_mb * 1024 * 1024 // 4
    x = torch.ones((n,), dtype=torch.float32, device=device)

    def passes(k):
        for _ in range(k):
            x.mul_(1.0000001)

    dt = (wall_seconds(lambda: passes(n_long), device, reps)
          - wall_seconds(lambda: passes(n_short), device, reps))
    bytes_moved = 2 * n * 4 * (n_long - n_short)
    rec = {"what": "hbm_stream", "bytes_moved": bytes_moved, "paired_dt_s": dt,
           "GB_per_s": bytes_moved / dt / 1e9}
    print(json.dumps(rec), flush=True)
    return rec


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    out = {"device": device_record(device)}
    print("start", out["device"], flush=True)
    shape = (8, 512) if q else (8, 512 * 1024)
    # (inner, n_long, n_short) of the reference's rows
    fma, trans = ((4, 4, 2), (2, 4, 2)) if q else ((256, 512, 64), (64, 256, 32))
    out["fma"] = measure("fma", "f32_fma", fma, shape, device, ops_per_eval=2)
    out["cos"] = measure("cos", "f32_cos", trans, shape, device)
    out["log"] = measure("log", "f32_log(abs+add+log)", trans, shape, device)
    out["div"] = measure("div", "f32_div(add+div)", trans, shape, device)
    out["exp"] = measure("exp", "f32_exp(abs+neg+exp)", trans, shape, device)
    kernel = dict(inner_long=16, inner_short=4, grid=2) if q else {}
    out["pallas_cos"] = measure_kernel_op("cos", "cos", device, **kernel)
    out["pallas_sin"] = measure_kernel_op("sin", "sin", device, **kernel)
    out["pallas_log"] = measure_kernel_op("log", "log(abs+add+log)", device, **kernel)
    noise = dict(inner_long=4, inner_short=2, programs=2) if q else {}
    out["pallas_noise"] = measure_noise(device, **noise)
    out["pallas_noise_paired"] = measure_noise(device, paired=True, **noise)
    out["hbm"] = measure_hbm(device, **(dict(n_mb=1, n_long=4, n_short=2) if q else {}))
    return out


def main(argv=None) -> dict:
    args = std_parser(__doc__).parse_args(argv)
    out = run(args)
    write_measure(args, "roofline", out)
    return out


if __name__ == "__main__":
    main()
