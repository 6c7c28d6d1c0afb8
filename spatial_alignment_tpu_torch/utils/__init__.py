"""Host-side utilities of the port: checkpoints, convergence checkers,
profiling and debug switches."""
