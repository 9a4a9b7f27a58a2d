"""ctypes binding of the native FASTQ/FASTA library (native/fastio.cpp).

The same library and signatures as sketch_rna_tpu/io/native.py, returning
the port's PackedReads / Packed2Reads / FastaRecords:

  pack_fastq_native(path, min_len, pad_len)  -> (PackedReads, stats)
  NativeFastqScan(path, min_len)             one scan, then pack_range /
                                             pack_range2 of any record range
  chunks_from_scan(scan, chunk_reads, ...)   8-bit chunks, packed one ahead
  iter_fastq_chunks_native(path, ...)        the scan and its 8-bit chunks
  chunks_from_scan2(scan, chunk_reads, ...)  2-bit chunks, packed one ahead
  LazyScanFeed(path, ...)                    the same feed, scanning on a
                                             background thread
  load_fasta_native(path)                    -> FastaRecords

The library builds on first use from native/fastio.cpp, with the flags
of native/Makefile and the compiler $CXX names (g++ by default), into
BUILD_DIR (build/native/ beside the package), never into native/: the
JAX package's loader rebuilds native/libfastio.so in place there.  The
build compiles to a temporary name and renames it into place, under an
exclusive lock on a file beside it, so first uses in several threads or
processes at once build it once and never load a partial file.  A failed
compile (no compiler, no zlib headers) logs a warning once and leaves
native_available() False; callers then take the Python parsers of
io/fasta.py and io/fastq.py, which stay the semantic reference.  A
library that compiled but does not load is built again and loaded once
more; only when the fresh build does not load either is that cached, as
a failed compile is.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import shlex
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import Packed2Reads, PackedReads

log = logging.getLogger(__name__)

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")  # native/Makefile's

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    # name: (restype, argtypes)
    "fastq_open_scan": (_P, [ctypes.c_char_p, _I64, _PI64, _PI64, _PI64, _PI64]),
    "fastq_open_scan_mt": (_P, [ctypes.c_char_p, _I64, ctypes.c_int, _PI64, _PI64, _PI64, _PI64]),
    "fastq_pack": (ctypes.c_int, [_P, _I64, _PU8, _PI32, ctypes.c_int]),
    "fastq_pack_range": (ctypes.c_int, [_P, _I64, _I64, _I64, _PU8, _PI32, ctypes.c_int]),
    "fastq_pack_range2": (ctypes.c_int, [_P, _I64, _I64, _I64, _PU8, _PI32, ctypes.c_int]),
    "fastq_ids_size": (_I64, [_P]),
    "fastq_get_ids": (ctypes.c_int, [_P, ctypes.c_char_p, _PI64]),
    "fastq_close": (None, [_P]),
    "fasta_open_scan": (_P, [ctypes.c_char_p, _PI64, _PI64]),
    "fasta_seq_len": (_I64, [_P, _I64]),
    "fasta_name_len": (_I64, [_P, _I64]),
    "fasta_get": (ctypes.c_int, [_P, _I64, ctypes.c_char_p, ctypes.c_char_p]),
    "fasta_close": (None, [_P]),
}

_load_lock = threading.Lock()
_libs: dict = {}  # library path -> its loaded, bound CDLL
_compile_failed: dict = {}  # library path -> why it failed to compile, or to load when fresh


def so_path() -> Path:
    """Where the library builds: BUILD_DIR/libfastio.so."""
    return BUILD_DIR / "libfastio.so"


def _build(so: Path, again: bool) -> Optional[str]:
    """Compile NATIVE_SRC into `so` unless a library at least as new as
    the source is there (or always, with `again`); None on success, else
    why the build failed.  Holds an exclusive lock on a file beside `so`,
    and renames the finished library into place."""
    if not NATIVE_SRC.exists():
        return f"{NATIVE_SRC} is missing"
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        with open(so.parent / f"{so.name}.lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not again and so.exists() and so.stat().st_mtime >= NATIVE_SRC.stat().st_mtime:
                return None
            fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=f".{so.stem}.", suffix=".so")
            os.close(fd)
            try:
                cxx = shlex.split(os.environ.get("CXX") or "g++")
                cmd = [*cxx, *CXXFLAGS, "-shared", "-o", tmp, str(NATIVE_SRC), "-lz"]
                subprocess.run(cmd, check=True, capture_output=True, timeout=300)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except (OSError, subprocess.SubprocessError) as e:  # no compiler, no zlib headers, no write access
        detail = (getattr(e, "stderr", b"") or b"").decode(errors="replace").strip()[-300:]
        return f"{e}{': ' + detail if detail else ''}"
    return None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built."""
    so = so_path()
    with _load_lock:  # one build per process, whichever thread asks first
        if so in _libs:
            return _libs[so]
        if so in _compile_failed:
            return None
        for again in (False, True):
            why = _build(so, again)
            if why is not None:
                log.warning("native fastio build failed (%s); using the Python parsers", why)
                _compile_failed[so] = why
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                if again:  # freshly built and still unloadable: lasting, as a failed compile
                    log.warning("native fastio load failed (%s); using the Python parsers", e)
                    _compile_failed[so] = f"load failed after a rebuild: {e}"
                    return None
                continue  # not whole: build it again under the lock
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _libs[so] = lib
            return lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastio unavailable")
    return lib


def native_available() -> bool:
    return _load() is not None


def _threads(n_threads: Optional[int]) -> int:
    return n_threads or min(os.cpu_count() or 1, 16)


def pack_fastq_native(
    path: str,
    min_len: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    with_ids: bool = False,
) -> Tuple[PackedReads, dict]:
    """Parse + filter + pack a FASTQ (plain or gzip) natively, with the
    semantics of load_fastq_dict + pack_reads: header-'@' records,
    uppercase-ACGT validation, min_len filter, last valid duplicate ID
    wins."""
    lib = _require()
    n_valid, n_seen, n_invalid, max_len = (ctypes.c_int64() for _ in range(4))
    h = lib.fastq_open_scan(path.encode(), min_len, ctypes.byref(n_valid), ctypes.byref(n_seen),
                            ctypes.byref(n_invalid), ctypes.byref(max_len))
    if not h:
        raise FileNotFoundError(f"Could not open FASTQ file: {path}")
    try:
        n = n_valid.value
        L = pad_len if pad_len is not None else max(int(max_len.value), min_len)
        codes = np.zeros((n, L), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        if n and lib.fastq_pack(h, L, codes.ctypes.data_as(_PU8), lengths.ctypes.data_as(_PI32), _threads(n_threads)):
            raise RuntimeError("fastq_pack failed")
        ids = [str(i) for i in range(n)]
        if with_ids and n:
            buf = ctypes.create_string_buffer(int(lib.fastq_ids_size(h)))
            offs = np.zeros(n + 1, dtype=np.int64)
            lib.fastq_get_ids(h, buf, offs.ctypes.data_as(_PI64))
            raw = buf.raw
            ids = [raw[offs[i] : offs[i + 1]].decode() for i in range(n)]
        stats = {"n_seen": int(n_seen.value), "n_invalid": int(n_invalid.value), "max_len": int(max_len.value)}
        return PackedReads(codes, lengths, ids), stats
    finally:
        lib.fastq_close(h)


class NativeFastqScan:
    """A scanned, not yet packed FASTQ held open for range packing.

    The scan already parsed, validated and deduplicated every record
    (last valid duplicate wins), so packing any record range later is
    the same as packing the whole file: chunk boundaries cannot change
    which reads exist.
    """

    def __init__(self, path: str, min_len: int, scan_threads: int = 0):
        self._lib = _require()
        n_valid, n_seen, n_invalid, max_len = (ctypes.c_int64() for _ in range(4))
        # scan_threads 0 picks a parallel byte-range scan for big files.
        self._h = self._lib.fastq_open_scan_mt(path.encode(), min_len, scan_threads, ctypes.byref(n_valid),
                                               ctypes.byref(n_seen), ctypes.byref(n_invalid), ctypes.byref(max_len))
        if not self._h:
            raise FileNotFoundError(f"Could not open FASTQ file: {path}")
        self.num_reads = int(n_valid.value)
        self.max_len = int(max_len.value)
        self.stats = {"n_seen": int(n_seen.value), "n_invalid": int(n_invalid.value), "max_len": self.max_len}

    def pack_range(self, start: int, count: int, pad_len: int, n_threads: Optional[int] = None) -> PackedReads:
        codes = np.zeros((count, pad_len), dtype=np.uint8)
        lengths = np.zeros(count, dtype=np.int32)
        if count and self._lib.fastq_pack_range(self._h, start, count, pad_len, codes.ctypes.data_as(_PU8),
                                                 lengths.ctypes.data_as(_PI32), _threads(n_threads)):
            raise RuntimeError("fastq_pack_range failed")
        return PackedReads(codes, lengths, [])

    def pack_range2(
        self,
        start: int,
        count: int,
        pad_len: int,
        n_threads: Optional[int] = None,
        out_rows: Optional[int] = None,
    ) -> Packed2Reads:
        """2-bit range packing (4 bases per byte; pad_len a multiple of
        4).  out_rows >= count zero-pads extra rows on the host."""
        if pad_len % 4:
            raise ValueError("pad_len must be a multiple of 4")
        rows = out_rows if out_rows is not None else count
        if rows < count:
            raise ValueError("out_rows < count")
        codes2 = np.zeros((rows, pad_len // 4), dtype=np.uint8)
        lengths = np.zeros(rows, dtype=np.int32)
        if count and self._lib.fastq_pack_range2(self._h, start, count, pad_len, codes2.ctypes.data_as(_PU8),
                                                  lengths.ctypes.data_as(_PI32), _threads(n_threads)):
            raise RuntimeError("fastq_pack_range2 failed")
        return Packed2Reads(codes2, lengths, pad_len, n_real=count)

    def close(self) -> None:
        if self._h:
            self._lib.fastq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _double_buffered(scan: NativeFastqScan, chunk_reads: int, pack, close: bool):
    """Yield pack(start, count) for each chunk of up to chunk_reads of the
    scan's reads, in order.  A background thread packs chunk c+1 while
    the consumer works on chunk c (the C call releases the GIL).  Closes
    the scan when done unless close=False."""
    try:
        n = scan.num_reads
        if n == 0:
            return
        starts = list(range(0, n, chunk_reads))
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(pack, starts[0], min(chunk_reads, n))
            for s in starts[1:]:
                cur = fut.result()
                fut = ex.submit(pack, s, min(chunk_reads, n - s))
                yield cur
            yield fut.result()
    finally:
        if close:
            scan.close()


def chunks_from_scan(
    scan: NativeFastqScan,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    close: bool = True,
):
    """Yield 8-bit PackedReads chunks of up to chunk_reads reads from an
    open scan, all at one pad_len (the scan's longest read by default),
    double-buffered as _double_buffered says."""
    L = pad_len if pad_len is not None else max(scan.max_len, 1)
    yield from _double_buffered(scan, chunk_reads, lambda s, c: scan.pack_range(s, c, L, n_threads), close)


def iter_fastq_chunks_native(
    path: str,
    min_len: int,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
):
    """Scan a FASTQ and feed its 8-bit chunks (chunks_from_scan), padded to
    pad_len or the longest read, at least min_len; the scan closes at the
    end."""
    scan = NativeFastqScan(path, min_len)
    if pad_len is None:
        pad_len = max(scan.max_len, min_len, 1)
    yield from chunks_from_scan(scan, chunk_reads, pad_len, n_threads)


def chunks_from_scan2(
    scan: NativeFastqScan,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    close: bool = True,
    row_multiple: int = 1,
):
    """Yield 2-bit Packed2Reads chunks of up to chunk_reads reads from an
    open scan, all at one pad_len (rounded up to a multiple of 4), rows
    padded to row_multiple, double-buffered as _double_buffered says."""
    L = pad_len if pad_len is not None else max(scan.max_len, 1)
    L = ((L + 3) // 4) * 4
    m = max(row_multiple, 1)

    def pack(s, c):
        return scan.pack_range2(s, c, L, n_threads, out_rows=((c + m - 1) // m) * m)

    yield from _double_buffered(scan, chunk_reads, pack, close)


class LazyScanFeed:
    """A 2-bit chunk feed whose native record scan runs on a background
    thread: construction returns at once, so the scan overlaps what the
    caller does next (the index upload).  Anything that needs the scan
    (num_reads, pad_len, iteration) joins the thread first; a scan error
    re-raises there."""

    def __init__(self, path: str, min_len: int, chunk_reads: int, pad_len: Optional[int] = None,
                 row_multiple: int = 1):
        self._path = path
        self._min_len = min_len
        self._chunk_reads = chunk_reads
        self._pad_len = pad_len
        self._row_multiple = row_multiple
        self._scan: Optional[NativeFastqScan] = None
        self._exc: Optional[BaseException] = None
        self._started = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._scan = NativeFastqScan(self._path, self._min_len)
        except BaseException as e:  # re-raised on the caller's thread at join
            self._exc = e

    @property
    def scan(self) -> NativeFastqScan:
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._scan

    @property
    def num_reads(self) -> int:
        return self.scan.num_reads

    @property
    def pad_len(self) -> int:
        if self._pad_len is not None:
            return self._pad_len
        return max(((self.scan.max_len + 7) // 8) * 8, self._min_len)

    def __iter__(self):
        # A generator: its body runs at the first step, so _started flips
        # only when chunks_from_scan2 is about to enter the try that
        # closes the scan.  iter(feed) alone leaves the scan to close().
        scan, pad_len = self.scan, self.pad_len
        self._started = True
        yield from chunks_from_scan2(scan, self._chunk_reads, pad_len, row_multiple=self._row_multiple, close=True)

    def close(self) -> None:
        """Close a scan that iteration never took over (never started, or
        started with iter() but never stepped).  Called from the caller's
        cleanup, so a late scan error is logged, not raised over the
        exception already in flight."""
        if self._started:
            return
        self._thread.join()
        if self._exc is not None:
            log.warning("background FASTQ scan failed during cleanup: %s", self._exc)
        elif self._scan is not None:
            self._scan.close()


def load_fasta_native(path: str) -> FastaRecords:
    lib = _require()
    n_records, n_invalid = ctypes.c_int64(), ctypes.c_int64()
    h = lib.fasta_open_scan(path.encode(), ctypes.byref(n_records), ctypes.byref(n_invalid))
    if not h:
        raise FileNotFoundError(f"Could not open FASTA file: {path}")
    try:
        names, seqs = [], []
        for i in range(n_records.value):
            nb = ctypes.create_string_buffer(int(lib.fasta_name_len(h, i)))
            sb = ctypes.create_string_buffer(int(lib.fasta_seq_len(h, i)))
            lib.fasta_get(h, i, nb, sb)
            names.append(nb.raw.decode())
            seqs.append(sb.raw.decode())
        return FastaRecords(names, seqs, int(n_invalid.value))
    finally:
        lib.fasta_close(h)
