"""Root-mean-square layer normalization: the hand-written Hopper kernel
(``csrc/rmsnorm.cu``) behind a checked wrapper.

Port of ``repro/kernels/rmsnorm.py`` (paper Table 2 "rmsnorm").  The
kernel's note in ``csrc/rmsnorm.cu`` says what bounds it on the card and
what its design does about that.  On a CPU tensor the wrapper computes
the plain version (:func:`repro_torch.kernels.ref.rmsnorm`); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches made by this process (the wrapper adds one per launch).
launches = 0


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, cols), gamma: (cols,) -> (rows, cols) in x's type."""
    global launches
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: need x (rows, cols) and gamma (cols,), "
                         f"got {tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.device.type == "cpu" and gamma.device.type == "cpu":
        return ref.rmsnorm(x, gamma, eps)
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"rmsnorm: x on {x.device} and gamma on "
                         f"{gamma.device}; the kernel needs one CUDA device")
    if x.dtype not in _build.DTYPE_CODES or gamma.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x and gamma must share f32 or bf16, got "
                        f"{x.dtype} and {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    y = torch.empty_like(x)
    lib = _build.library()
    err = lib.repro_rmsnorm(x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                            x.shape[0], x.shape[1], float(eps),
                            _build.DTYPE_CODES[x.dtype],
                            _build.stream_handle(x.device))
    _build.check(err, "rmsnorm")
    launches += 1
    return y
