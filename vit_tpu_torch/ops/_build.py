"""Build, load and count the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point of the
same name. At first use it is compiled with ``nvcc`` for ``sm_90a`` into
``vit_tpu_torch/_build/<hash>/<name>.so`` (``<hash>`` covers every file in
``csrc/`` and the flags, so an edited source rebuilds) and loaded with
``ctypes``. :func:`build_all` starts one ``nvcc`` per source at once.

Every entry point returns ``cudaGetLastError()`` after its launch;
:meth:`Kernel.launch` raises on a non-zero code and otherwise adds one to
the kernel's ``launches`` count. A failed build raises with nvcc's stderr:
there is no fallback to the plain version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Kernel", "KERNELS", "build_all", "build_dir", "find_nvcc", "reset_launches"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the CUDA kernels of vit_tpu_torch are built with the CUDA toolkit "
            "on the machine with the card"
        )
    return found


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    """The directory the current sources' libraries are built into and
    loaded from: ``vit_tpu_torch/_build/<hash of csrc/ and the flags>``."""
    return os.path.join(BUILD_ROOT, _sources_hash())


@dataclass
class Kernel:
    """One hand-written kernel: its source, C signature and launch count."""

    name: str
    replaces: str  # the Pallas kernels it ports (hash_dropout: a jnp function), file:line[,...]
    argtypes: Tuple
    launches: int = 0
    _fn: Optional[ctypes._CFuncPtr] = field(default=None, repr=False)
    build_log: str = field(default="", repr=False)

    @property
    def source(self) -> str:
        return os.path.join(CSRC_DIR, f"{self.name}.cu")

    @property
    def lib_path(self) -> str:
        return os.path.join(build_dir(), f"{self.name}.so")

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, str, str]]:
        out = self.lib_path
        if os.path.exists(out):
            return None
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, self.source]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        return proc, tmp, out

    def _finish_build(self, started) -> None:
        proc, tmp, out = started
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source} (exit {proc.returncode}):\n"
                f"{stderr}{stdout}"
            )
        self.build_log = stderr
        os.replace(tmp, out)

    def fn(self):
        """The loaded C entry point, building the library first if needed."""
        if self._fn is None:
            started = self._start_build()
            if started is not None:
                self._finish_build(started)
            lib = ctypes.CDLL(self.lib_path)
            fn = getattr(lib, self.name)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise on a CUDA error, else count the launch."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


# The dropout tail of the attention kernels: (dropout, seed, bh_per_seed,
# bh_offset, threshold, inv_keep, stream); the seed is a device pointer to
# int32 seeds, one for every bh_per_seed heads, which the kernels read, so a
# captured launch takes the seeds its buffer holds; bh_offset is the launch's
# first global head.
_DROP = (_I, _P, _I, _I, _U, _F, _P)
# (q, k, v, o, lse, bh, t, d, scale, is_bf16, *dropout tail)
_ATTN_FWD = (_P,) * 5 + (_I, _I, _I, _F, _I) + _DROP
# (q, k, v, dout, lse, delta, *outputs, bh, t, d, scale, is_bf16, *dropout tail)
_ATTN_BWD_TAIL = (_I, _I, _I, _F, _I) + _DROP
# (x, w1, b1, w2, b2, y, h, rows, d, f, is_bf16, stream); h is the wide route's
# (rows, f) scratch, null elsewhere
_MLP_FWD = (_P,) * 7 + (_I, _I, _I, _I, _P)
# (x, dy, w1, b1, w2, dx, g, dh, partials, grads, rows, d, f, n_seg, is_bf16,
#  body, stream); body 0 FMA, 1 on-chip tensor cores, 2 wide; g and dh are the
#  FMA and wide bodies' (rows, f) scratch, null on the on-chip body
_MLP_BWD = (_P,) * 10 + (_I,) * 6 + (_P,)
# (x, y, numel, rank, replicas, dims[7], offsets[7], seed, seed pointer, threshold,
#  1/keep, dtype, stream); the seed pointer is the device int32 seed (null for
#  ``seed``), or with replicas (1: x's first axis) one seed a replica
_HASH_DROPOUT = ((_P, _P, ctypes.c_longlong, _I, _I) + (_I,) * 7 + (_U,) * 7
                 + (_U, _P, _U, _F, _I, _P))

KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("flash_fwd", "vit_tpu/ops/flash_attention.py:359", _ATTN_FWD),
        Kernel("short_fwd", "vit_tpu/ops/flash_attention.py:203", _ATTN_FWD),
        Kernel("fused_mlp_fwd", "vit_tpu/ops/fused_mlp.py:72", _MLP_FWD),
        # K4 and K5 as one kernel: (q, k, v, dout, lse, delta, dq, dk, dv, dq_ws,
        # counters, ...); dq_ws and counters are the bf16 pass's dQ scratch
        Kernel("flash_bwd", "vit_tpu/ops/flash_attention.py:459,496",
               (_P,) * 11 + _ATTN_BWD_TAIL),
        Kernel("short_bwd", "vit_tpu/ops/flash_attention.py:224", (_P,) * 9 + _ATTN_BWD_TAIL),
        Kernel("fused_mlp_bwd", "vit_tpu/ops/fused_mlp.py:83", _MLP_BWD),
        # no Pallas kernel: vit_tpu's hash dropout, jnp ops that XLA fuses
        Kernel("hash_dropout", "vit_tpu/ops/dropout.py:77", _HASH_DROPOUT),
    )
}


def build_all() -> Tuple[float, Dict[str, str]]:
    """Build every kernel not yet built, one ``nvcc`` each, all at once.

    Returns (seconds, {name: nvcc's stderr, which holds ``-Xptxas -v``'s
    register and shared-memory report}). Raises on the first failed build
    after all have finished.
    """
    t0 = time.perf_counter()
    started: List[Tuple[Kernel, tuple]] = []
    for k in KERNELS.values():
        s = k._start_build()
        if s is not None:
            started.append((k, s))
    errors = []
    for k, s in started:
        try:
            k._finish_build(s)
        except RuntimeError as e:  # collect, then raise once all have ended
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k.fn()
    return time.perf_counter() - t0, {k.name: k.build_log for k in KERNELS.values()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
