"""Plain PyTorch references of the benchmark's configurations: float32
arithmetic, no kernels, no cache, written from the published configs.
Nothing here imports ``repro_torch`` or JAX."""
