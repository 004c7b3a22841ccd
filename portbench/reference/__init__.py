"""The benchmark's plain reference: plain PyTorch, independent of the
program. One module per plant (its dynamics, cost and bounds) and one per
solver family (``episodes``: a batch's closed-loop episodes for chosen
scenarios), found by the names a configuration gives; ``noise`` and
``loop`` are shared."""
