"""Build and load the hand-written CUDA kernels in csrc/.

One nvcc per csrc/*.cu, all started together, compiles the sources to
objects; one more links them into a shared library with a plain C
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
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the build log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # codes, lengths, out_hashes, out_mask, out_overflow, B, L, k, threshold, cap, stream
    "fused_sketch_launch": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _P],
    # codes, lengths, num_k, ks, caps, out_hashes, out_masks, out_overflows
    # (host arrays of num_k), B, L, threshold, stream
    "fused_sketch_multik_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, ctypes.c_uint, _P],
    # L, k -> tiles per row of the two K3 passes
    "nthash_kept_tiles": [_I, _I],
    # codes, lengths, tile_counts, B, L, k, threshold, stream
    "nthash_count_launch": [_P, _P, _P, _I, _I, _I, ctypes.c_uint, _P],
    # codes, lengths, incl, out_hashes, out_windows, B, L, k, threshold, m, stream
    "nthash_kept_launch": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _P],
    # x, out, B, W, stream
    "row_sort_launch": [_P, _P, _I, _I, _P],
    "row_sort_i64_launch": [_P, _P, _I, _I, _P],
    # x, out, N, W (= 2w), stream
    "merge_pairs_launch": [_P, _P, _I, _I, _P],
    "merge_pairs_i64_launch": [_P, _P, _I, _I, _P],
    # hashes, mask, packed, out_start, out_length, n, nb, mb, shift, stream
    "bucket_probe_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # values, n, perm, is_start, seg_end, seg_live, carry_tid, carry_on,
    # scratch, flags, ps, nblk, T, stream
    "segsum_f64_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "segsum_f32_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "segsum_i32_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in procs:  # wait for every compile, failed or not
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu ({proc.returncode})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_so), *(str(obj) for obj, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so)  # atomic: a concurrent loader never sees a partial file
    return Build(so, time.perf_counter() - t0, log)


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
