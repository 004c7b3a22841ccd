"""The benchmark of benchmarking_mpc_solvers_tpu_torch: ``python3 -m portbench.run``."""
