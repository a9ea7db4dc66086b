"""The benchmark of vit_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, ".bench_cache")
# Build and kernel caches at fixed paths inside the checkout; nothing the
# port uses may pull in JAX by way of transformers.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
# One process with few threads: the host's share of a per-step run is the
# main thread's, and idle worker threads only add jitter to it.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [BENCH, ROOT]

from benchlib.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
