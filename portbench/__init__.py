"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
measures or judges the program lives here and imports neither ``jax``
nor the JAX package; ``portbench/reference/`` imports no ``repro_torch``
either.
"""
