"""Build and load the hand-written CUDA kernels in csrc/.

nvcc compiles every csrc/*.cu into one shared library with a plain C
interface, loaded with ctypes.  No source includes PyTorch's headers, so
the build takes seconds rather than the minutes a torch extension needs.
It runs at the first CUDA use, into build/kernels/ beside the package,
keyed by a hash of the sources and flags: a fresh checkout builds once,
and an edited source rebuilds.  Importing this module needs neither nvcc
nor a GPU.

Each C entry point launches on the stream it is given, allocates
nothing, and returns cudaGetLastError(); `check` turns a nonzero code
into an exception.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the build log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # codes, lengths, tables, out_hashes, out_mask, out_overflow,
    # B, L, k, threshold, cap, nk_pad, stream
    "fused_sketch_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _I, _P],
    # x, out, B, W, stream
    "row_sort_launch": [_P, _P, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when a matching library existed
    log: str  # nvcc's output (ptxas resource usage per kernel)


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile csrc/*.cu into build/kernels/ unless the same sources were
    already built there."""
    so = BUILD_DIR / f"libsketch_rna_kernels_{_digest()}.so"
    if so.exists():
        return Build(so, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return Build(so, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
