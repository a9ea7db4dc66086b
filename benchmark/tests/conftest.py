"""The benchmark's tests: its files, counts, hash, reference and result line
on the CPU; the control on the card (``cuda`` marker, skipped without one).

    python -m pytest benchmark/tests -q
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (CUDA kernels); skips without one")
