"""repro_torch: the PyTorch / CUDA port of ``repro`` for an NVIDIA H100.

It imports neither ``jax`` nor ``repro``; the JAX package is the
reference its tests hold it against.  Kernels on the port's path are
hand-written for Hopper (``repro_torch.kernels``).  Entry points run on
the card unless the caller asks for the CPU.
"""

__version__ = "1.0.0"
