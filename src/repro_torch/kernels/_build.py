"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(one ``nvcc`` process per source, all started together), and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lives under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is.  The build happens at
the first launch, never at import: the CPU tests import this module on a
host with no ``nvcc``.  A failed build raises with ``nvcc``'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

# element-type codes of the C interface (csrc/common.cuh: repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (x, gamma, y, rows, cols, eps, dtype, stream)
    "repro_rmsnorm": [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    # (x, wg, wu, out, M, K, N, dtype, stream)
    "repro_fused_ff": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal, window, q_offset,
    #  dtype, stream)
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _I, _I, _I, _I, _P],
    # (a, b, out, M, K, N, negative_slope, dtype, stream)
    "repro_matmul_leakyrelu": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                               _P],
    # (a, b, out, B, M, K, N, dtype, stream)
    "repro_bmm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for cmd, _, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        staged = Path(tmp) / target.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
               *(str(obj) for _, obj, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(staged, target)   # atomic: a reader never sees half a file


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and cached per process."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _compile(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
