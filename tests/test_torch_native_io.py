"""The port's binding of native/fastio.cpp against the JAX package's.

Both bind the same library: the fixture points the JAX binding at the
port's build of it (the same source and flags), so a JAX build that
another process is rewriting in place cannot fail the comparison.  On
the same plain and gzip FASTQ / FASTA files every array, id and count
must be equal, and equal to the port's Python parsers; so must the 8-bit
and 2-bit chunk feeds.  scripts/make_fastq_torch.py's records read
back through the Python and native parsers to the reads drawn.  The
tests skip, with the reason, only when the library cannot be built on
this machine.
"""

import gzip
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from sketch_rna_tpu.io import native as jax_native
from sketch_rna_tpu_torch.io import native
from sketch_rna_tpu_torch.io.fasta import load_fasta
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.io.packing import pack_reads, unpack_codes2
from sketch_rna_tpu_torch.utils import synth
from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_fastq_torch  # noqa: E402


@pytest.fixture(scope="module")
def lib():
    if not native.native_available():
        pytest.skip(f"native fastio library did not build ({native.so_path()})")
    with pytest.MonkeyPatch.context() as mp:  # the JAX binding loads the port's whole build
        mp.setattr(jax_native, "_SO_PATH", str(native.so_path()))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        assert jax_native.native_available()
        yield


def _fastq(tmp_path, rng, n=700, gz=False):
    lines = []
    for i in range(n):
        ln = int(rng.integers(20, 160))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
        lines.append(f"@read{i} extra\n{seq}\n+\n{'I' * ln}\n")
    lines.append("@read3 extra\n" + "ACGT" * 20 + "\n+\n" + "I" * 80 + "\n")  # duplicate: last wins
    lines.append("@bad\nACGTNACGTACGTACGTACGTACGTACGTACGTACGT\n+\n" + "I" * 37 + "\n")  # invalid
    text = "".join(lines)
    path = tmp_path / ("r.fq.gz" if gz else "r.fq")
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
def test_pack_fastq_native_equals_jax(lib, tmp_path, gz):
    path = _fastq(tmp_path, np.random.default_rng(1), gz=gz)
    got, stats = native.pack_fastq_native(path, min_len=31, with_ids=True)
    want, want_stats = jax_native.pack_fastq_native(path, min_len=31, with_ids=True)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.ids == want.ids and stats == want_stats
    d = load_fastq_dict(path, min_len=31)
    py, _, _ = pack_reads(list(d.values()), list(d.keys()), min_len=31, pad_len=got.padded_len)
    np.testing.assert_array_equal(got.codes, py.codes)
    assert got.ids == py.ids


@pytest.mark.parametrize("gz", [False, True])
def test_scan_ranges_and_chunks_equal_jax(lib, tmp_path, gz):
    path = _fastq(tmp_path, np.random.default_rng(2), gz=gz)
    with native.NativeFastqScan(path, 31) as scan, jax_native.NativeFastqScan(path, 31) as ref:
        assert (scan.num_reads, scan.max_len, scan.stats) == (ref.num_reads, ref.max_len, ref.stats)
        a, b = scan.pack_range(100, 57, 160), ref.pack_range(100, 57, 160)
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        a2, b2 = scan.pack_range2(10, 90, 160, out_rows=96), ref.pack_range2(10, 90, 160, out_rows=96)
        np.testing.assert_array_equal(a2.codes2, b2.codes2)
        np.testing.assert_array_equal(a2.lengths, b2.lengths)
        assert (a2.num_reads, a2.pad_len) == (b2.num_reads, b2.pad_len) == (90, 160)
        np.testing.assert_array_equal(unpack_codes2(a2.codes2, 160)[:90], scan.pack_range(10, 90, 160).codes)
        for chunk_reads, multiple in ((64, 1), (250, 32), (4096, 64)):
            got = list(native.chunks_from_scan2(scan, chunk_reads, 157, row_multiple=multiple, close=False))
            want = list(jax_native.chunks_from_scan2(ref, chunk_reads, 157, row_multiple=multiple, close=False))
            assert len(got) == len(want) and sum(c.num_reads for c in got) == scan.num_reads
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.codes2, w.codes2)
                np.testing.assert_array_equal(g.lengths, w.lengths)
                assert (g.pad_len, g.num_reads, g.codes2.shape[0] % multiple) == (w.pad_len, w.num_reads, 0)


def _same_chunks(got, want, pad_len):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        assert g.padded_len == w.padded_len == pad_len


@pytest.mark.parametrize("chunk_reads", [64, 250, 4096])
def test_8bit_chunk_feed_equals_jax(lib, tmp_path, chunk_reads):
    """chunks_from_scan and iter_fastq_chunks_native: the JAX package's
    chunks, a short last chunk, one shared pad_len, and the scan left
    open by close=False, closed by default."""
    path = _fastq(tmp_path, np.random.default_rng(4))
    with native.NativeFastqScan(path, 31) as scan, jax_native.NativeFastqScan(path, 31) as ref:
        n = scan.num_reads
        assert n % chunk_reads
        got = list(native.chunks_from_scan(scan, chunk_reads, 157, close=False))
        _same_chunks(got, list(jax_native.chunks_from_scan(ref, chunk_reads, 157, close=False)), 157)
        assert [c.num_reads for c in got] == [min(chunk_reads, n - s) for s in range(0, n, chunk_reads)]
        np.testing.assert_array_equal(np.concatenate([c.codes for c in got]), scan.pack_range(0, n, 157).codes)
        assert scan._h is not None  # close=False: the scan stays open for more
        got = list(native.chunks_from_scan(scan, chunk_reads))  # pad_len: the longest read
        _same_chunks(got, list(jax_native.chunks_from_scan(ref, chunk_reads)), scan.max_len)
        assert scan._h is None
    for pad_len in (None, 170):
        got = list(native.iter_fastq_chunks_native(path, 31, chunk_reads, pad_len))
        want = list(jax_native.iter_fastq_chunks_native(path, 31, chunk_reads, pad_len))
        _same_chunks(got, want, pad_len or max(c.lengths.max() for c in got))
        assert sum(c.num_reads for c in got) == n


def test_lazy_scan_feed_equals_jax(lib, tmp_path):
    path = _fastq(tmp_path, np.random.default_rng(3))
    feed = native.LazyScanFeed(path, 31, 128, row_multiple=32)
    ref = jax_native.LazyScanFeed(path, 31, 128, row_multiple=32)
    assert (feed.num_reads, feed.pad_len) == (ref.num_reads, ref.pad_len)
    for g, w in zip(list(feed), list(ref)):
        np.testing.assert_array_equal(g.codes2, w.codes2)
        np.testing.assert_array_equal(g.lengths, w.lengths)
    feed.close()  # iteration took the scan over: a no-op
    unused = native.LazyScanFeed(path, 31, 128)
    unused.close()  # closes a scan that was never iterated


def test_load_fasta_native_equals_jax(lib, tmp_path):
    path = tmp_path / "t.fa"
    path.write_text(">tx1 desc\nACGTACGT\nACGT\n\n>tx2\nGGGG\n>bad\nACGTN\n>tx1 dup\nTTTT\n")
    got, want, py = native.load_fasta_native(str(path)), jax_native.load_fasta_native(str(path)), load_fasta(str(path))
    assert (got.names, got.seqs, got.n_invalid) == (want.names, want.seqs, want.n_invalid)
    assert (got.names, got.seqs, got.n_invalid) == (py.names, py.seqs, py.n_invalid)


def test_missing_file_raises(lib):
    with pytest.raises(FileNotFoundError):
        native.pack_fastq_native("/nonexistent/x.fq", min_len=31)
    with pytest.raises(FileNotFoundError):
        native.NativeFastqScan("/nonexistent/x.fq", 31)
    with pytest.raises(FileNotFoundError):
        native.load_fasta_native("/nonexistent/x.fa")


# One process of test_concurrent_first_builds_all_load: say it is ready
# (a file of its own in the ready directory), wait for the go file, build
# into the given directory, parse the sample FASTQ, print a digest of the
# arrays.
_FIRST_BUILD = """
import hashlib, os, sys, time
from pathlib import Path
from sketch_rna_tpu_torch.io import native
native.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[4], str(os.getpid())).touch()
while not os.path.exists(sys.argv[2]):
    time.sleep(0.005)
ok = native.native_available()
reads, stats = native.pack_fastq_native(sys.argv[3], min_len=31, with_ids=True)
h = hashlib.sha256(reads.codes.tobytes() + reads.lengths.tobytes() + "\\n".join(reads.ids).encode())
print(ok, reads.codes.shape, sorted(stats.items()), h.hexdigest())
"""


def test_concurrent_first_builds_all_load(tmp_path):
    """Six processes build the library at once into a directory that
    holds none: each loads a whole library and parses the sample alike."""
    if shutil.which((os.environ.get("CXX") or "g++").split()[0]) is None:
        pytest.skip("no C++ compiler")
    build, go, ready = tmp_path / "native", tmp_path / "go", tmp_path / "ready"
    ready.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    args = [str(build), str(go), str(ROOT / "examples" / "sample.fq"), str(ready)]
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_BUILD, *args], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(6)]
    deadline = time.monotonic() + 120
    while len(list(ready.iterdir())) < 6:  # every process waits at the go file before any builds
        assert all(p.poll() is None for p in procs), [p.communicate()[1][-800:] for p in procs if p.poll()]
        assert time.monotonic() < deadline, f"{len(list(ready.iterdir()))} of 6 processes ready"
        time.sleep(0.01)
    assert not build.exists()
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err[-800:] for _, err in outs]
    lines = [out.strip().splitlines()[-1] for out, _ in outs]
    assert lines[0].startswith("True ") and len(set(lines)) == 1, lines
    assert sorted(p.name for p in build.iterdir()) == ["libfastio.so", "libfastio.so.lock"]


@pytest.mark.parametrize("parser", ["python", "native"])
def test_make_fastq_reads_back(parser, tmp_path):
    """make_fastq_torch's records, chunk by chunk from their seeds, read
    back through the port's parsers to the codes sample_reads drew,
    reads shorter than --read-len at their own length."""
    if parser == "native" and not native.native_available():
        pytest.skip("the native FASTQ parser did not build")
    path = str(tmp_path / "reads.fq")
    n, chunk, n_tx = 3000, 1100, 300
    assert make_fastq_torch.main([path, "--transcripts", str(n_tx), "--reads", str(n), "--chunk", str(chunk)]) == 0
    seqs = synth_transcriptome(np.random.default_rng(synth.GENCODE_SEED), n_tx)
    codes, lengths = [], []
    for r0 in range(0, n, chunk):
        c, length = sample_reads(seqs, min(chunk, n - r0), 150, 150, seed=1000 + r0 % 997)
        codes.append(c)
        lengths.append(length)
    codes, lengths = np.concatenate(codes), np.concatenate(lengths)
    assert (lengths < 150).any()  # the short-read framing is exercised
    if parser == "python":
        reads = load_fastq_dict(path)
        assert list(reads) == [f"r{i:010d}" for i in range(n)]
        want = ["".join("ACGT"[b] for b in codes[i, : lengths[i]]) for i in range(n)]
        assert list(reads.values()) == want
    else:
        packed, stats = native.pack_fastq_native(path, min_len=1)
        assert packed.num_reads == n and stats["max_len"] == 150
        np.testing.assert_array_equal(packed.lengths, lengths)
        np.testing.assert_array_equal(packed.codes[:, :150], codes)
