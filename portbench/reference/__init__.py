"""The plain reference of the benchmark: the frozen mesh generator, P1
assembly and boundary sets, the Stokes double-projection step and the
semi-Lagrangian dye, in plain NumPy and PyTorch.  It imports nothing of the
program under test."""
