"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
(one ``nvcc`` process per source, all started together), and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lives under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is.  The build happens at
the first launch, never at import: the CPU tests import this module on a
host with no ``nvcc``.  A failed build raises with ``nvcc``'s stderr.

    python -m repro_torch.kernels._build --ptxas

prints what ``ptxas -v`` says of every kernel instance (registers,
spills, shared memory), on a machine with ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

# element-type codes of the C interface (csrc/common.cuh: repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # (x, gamma, y, rows, cols, eps, tiling, dtype, stream)
    "repro_rmsnorm": [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P],
    # (x, wg, wu, out, work, M, K, N, splits, tiling, dtype, stream)
    "repro_fused_ff": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (q, k, v, o, lse, B, H, KH, Sq, Sk, D, Dv, scale, causal, window,
    #  q_offset, tiling, dtype, stream)
    "repro_flash_attention": [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I,
                                                     _I, _I, _I, _P],
    # (q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta, B, H, KH, Sq, Sk,
    #  D, Dv, scale, causal, window, q_offset, tiling, stream)
    "repro_flash_attention_backward": [_P] * 11 + [_I] * 7
    + [ctypes.c_float, _I, _I, _I, _I, _P],
    # (a, b, out, M, K, N, negative_slope, tiling, dtype, stream)
    "repro_matmul_leakyrelu": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                               _I, _P],
    # (a, b, out, B, M, K, N, tiling, dtype, stream)
    "repro_bmm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (x, y, rows, cols, tiling, dtype, stream)
    "repro_softmax": [_P, _P, _I, _I, _I, _I, _P],
    # (x, a, b, c, y, work, B, S, H, G, P, N, the strides of x, a, b and
    #  c (batch, sequence, head or group), segments, tiling, dtype, stream)
    "repro_ssd": [_P] * 6 + [_I] * 6 + [_L] * 12 + [_I, _I, _I, _P],
    # (B, S, H, G, P, N, max_segments, tiling, dtype)
    "repro_ssd_segments": [_I] * 9,
}

# the kernels' lists of tiling names, by id, comma-separated (no arguments)
_TILING_LISTS = ("repro_flash_attention_tilings",
                 "repro_flash_attention_backward_tilings", "repro_gemm_tilings",
                 "repro_rmsnorm_tilings", "repro_fused_ff_tilings",
                 "repro_softmax_tilings", "repro_ssd_tilings")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tiling_ids: Dict[str, Dict[str, int]] = {}
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
    """The kernel library, built on first use and cached per process.
    Once loaded it is returned without taking the lock: every launch
    comes through here."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
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
            for name in _TILING_LISTS:
                fn = getattr(lib, name)
                fn.argtypes = []
                fn.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def tiling_ids(symbol: str, names: Sequence[str]) -> Dict[str, int]:
    """{name: id} of the kernel instances ``names`` (a wrapper's
    ``TILINGS``), after checking that the library's list ``symbol``
    names the same instances in the same order."""
    ids = _tiling_ids.get(symbol)
    if ids is None:
        built = tuple(getattr(library(), symbol)().decode().split(","))
        if built != tuple(names):
            raise RuntimeError(f"{symbol}: the library's tilings {built} "
                               f"are not the wrapper's {tuple(names)}")
        ids = _tiling_ids[symbol] = {n: i for i, n in enumerate(names)}
    return ids


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a device
    with an index, as a CUDA tensor's is), without building a Stream
    object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def ptxas_report() -> str:
    """What ``ptxas -v`` says of every kernel the library holds: one line
    per kernel instance with its registers, spills and shared memory,
    from one ``nvcc`` process per source (all started together), compiled
    with the library's flags into a scratch directory."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lines = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *CFLAGS, "-Xptxas", "-v", "-c", str(src),
             "-o", str(Path(tmp) / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src in _sources()]
        for src, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}{err}")
            name, spills = None, ""
            for line in (out + err).splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = _demangle(m.group(1))
                elif "spill stores" in line:
                    spills = line.strip()
                elif "Used" in line and "registers" in line and name:
                    lines.append(f"{src.name}: {name}: "
                                 f"{line.split(':', 1)[1].strip()}; {spills}")
                    name = None
    return "\n".join(lines)


def _demangle(symbol: str) -> str:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return symbol
    out = subprocess.run([tool, symbol], capture_output=True, text=True)
    name = out.stdout.strip() or symbol
    return re.sub(r"repro::\(anonymous namespace\)::", "", name)


if __name__ == "__main__":
    import sys
    if sys.argv[1:] != ["--ptxas"]:
        raise SystemExit("usage: python -m repro_torch.kernels._build "
                         "--ptxas")
    print(ptxas_report())
