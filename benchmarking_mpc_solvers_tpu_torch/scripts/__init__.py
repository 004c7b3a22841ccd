"""The study's entry points: the sweeps, tables and quality check.

Counterparts of the JAX package's ``scripts/``, module for module, each run
as ``python -m benchmarking_mpc_solvers_tpu_torch.scripts.<name>``. Each
sweep builds its configurations in ``grid(args)`` and runs them on the card
(``--device``, default ``cuda``) into ``results_torch/``; ``results/`` holds
the JAX package's own study runs, which the host scripts only read.
"""
