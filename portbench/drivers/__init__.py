"""Drivers: one module a kind of work, named by a mix's ``driver`` key.
Each has ``run(ctx: portbench.harness.Run) -> portbench.harness.Record``."""
