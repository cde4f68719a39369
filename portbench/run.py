"""Run one cell of BENCHMARK.json once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
the result (JSON); the numbers compared against the reference, each
beside its limit, are the last lines of standard error.  Without enough
CUDA devices for the cell it exits 2 and prints no result.
"""

import time

STARTED = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "portbench")
# every build and kernel cache at a fixed path inside the checkout (the
# port's own kernels build into ROOT/build/kernels)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED, ROOT))
