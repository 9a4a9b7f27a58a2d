#!/usr/bin/env python3
"""Drive the PyTorch port (sketch_rna_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py                    # from the repository root; needs one card
    python3 chip_smoke.py --phases kernels   # a subset (device and build always run)

Phases, in order; any failure raises and the script exits nonzero
without printing its result line:

  device        torch / CUDA versions, the card's name and power limit;
  build         nvcc builds the kernels in csrc/, one process per source;
  kernels       K1 (fused sketch), K2 (multi-k fused sketch), K3 (hash
                plane), K4 (row sort, int32) and K4-int64 against their
                plain PyTorch versions on the card, bit for bit, with times;
  sample        the port's CLI on examples/sample.{fa,fq}, k=31: the
                float64 CSV is byte-identical to examples/sample.expected.csv,
                the float32 CSV within 1e-4 relative;
  sample-multik the CLI with -k 21,31, float64, on the card and in-process
                with --device cpu: same rows, values within 1e-9 relative;
  scale         6,000 synthetic isoform-family transcripts + 1,000,000
                reads of 100 bp, k=31, batch 8192, float32 EM;
  scale-multik  the c3_chr20_multik configuration: 20,000 transcripts
                (synth_transcriptome, seed 22) + 2,097,152 reads of 100 bp,
                k=(21, 31), batch 8192, float32 EM;
  spill         300 transcripts sharing an 80-base core, ks (15, 31),
                C=8: per-k tables spill and the batch regroups merged,
                equal to a forced merged run;
  long-reads    2,000 synthetic transcripts (families of 3-8 kb) + 100,000
                reads of 2,000 bp from those that hold one, k=31: reads past
                1024 windows sketch through K3 + K4-int64 alone; then
                2,000 reads of 20,000 bp (nk_pad 32768) at k=31, whose dedup
                sorts through row_sort_wide (K4-int64 chunks + merges);
  stream        the scale-multik index and reads at float64 EM: the
                streamed engine (default knobs; a 2^16-row class buffer that
                compacts and drains; one full-width buffer) equals the fused
                run within 1e-9 relative;
  stream-c3     BASELINE config 3 at its published size: 10,000,000 x 100 bp
                reads against the 20,000-transcript stand-in, k=(21, 31),
                streamed from 2-bit chunks made chunk by chunk, float32 EM;
  cli-stream    the CLI's quant on a 2,200,000-read FASTQ: past the fused
                bound it must take the streamed route over the native scan
                feed (the Python feed, said so, if the native parser cannot
                build); the CSV equals in-process quantify_streamed;
  samples       examples/sample.{fa,fq}: refbin and npz indexes, a
                two-sample quant with --tpm (TPM = numpy recompute), and an
                EM checkpoint stopped after 2 iterations and resumed, equal
                to the one-shot run byte for byte.

With --profile, one steady streamed quant of the scale-multik reads runs
under torch.profiler last: device busy / idle share and time by item.

A scale phase builds its index on the card, runs one warm-up and one
timed quant (reads/s, stage seconds), counts kernel launches over the
timed quant (every count set to 0 just before it), checks read-count
conservation and zero dropped work, and holds the first batch's
candidate tables against the plain functions on the same tensors.

Then one JSON line per kernel ({"kernels": [...]}), the nvidia-smi line
of the card, and last {"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 1234
BATCH = 8192
# (transcripts, reads) of the scale phases
SCALE = (6000, 1_000_000)
SCALE_MULTIK = (20000, 1 << 21)
LONG_READS = (2000, 100_000)
VERY_LONG = (200, 2000, 20000)  # (transcripts, reads, read length)
C3_READS = 10_000_000
CLI_READS = 2_200_000
PHASES = ("kernels", "sample", "sample-multik", "scale", "scale-multik", "spill", "long-reads", "stream",
          "stream-c3", "cli-stream", "samples")
KERNELS = {
    "K1": ("fused_sketch", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:160"),
    "K2": ("fused_sketch_multik", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:266"),
    "K3": ("nthash_sketch", "sketch_rna_tpu_torch/csrc/hash.cu", "sketch_rna_tpu/hash/pallas_hash.py:46"),
    "K4": ("row_sort", "sketch_rna_tpu_torch/csrc/row_sort.cu", "sketch_rna_tpu/match/pallas_sort.py:49"),
    "K4-int64": ("row_sort (int64 keys)", "sketch_rna_tpu_torch/csrc/row_sort.cu",
                 "sketch_rna_tpu/match/pallas_sort.py:49"),
}


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_pair_ms(torch, kernel, plain, reps: int = 20):
    """Median CUDA-event times of two callables, measured in turns
    (plain, kernel, kernel, plain) and averaged per callable."""

    def median_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    p1, k1, k2, p2 = median_ms(plain), median_ms(kernel), median_ms(kernel), median_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def counters():
    """Each kernel wrapper's launch count (name -> (object, attribute))."""
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match.row_sort import row_sort

    return {"K1": (fused_sketch, "launches"), "K2": (fused_sketch_multik, "launches"),
            "K3": (nthash_sketch, "launches"), "K4": (row_sort, "launches"),
            "K4-int64": (row_sort, "launches_i64")}


def reset_launches() -> None:
    for obj, attr in counters().values():
        setattr(obj, attr, 0)


def read_launches() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in counters().items()}


def record(results, name, **kw) -> None:
    """Merge measurements into a kernel's entry; max_abs_err keeps its maximum."""
    entry = results[name]
    if "max_abs_err" in kw:
        kw["max_abs_err"] = max(entry.get("max_abs_err", 0), kw["max_abs_err"])
    entry.update(kw)


def same_tensors(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def max_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(got, want))


def phase_device(torch) -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card (name, power limit): {smi}")
    return smi


def phase_build():
    from sketch_rna_tpu_torch import kernels

    t0 = time.perf_counter()
    build = kernels.build()
    kernels.library()
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s (nvcc {build.seconds:.2f} s) -> {build.path}")
    for line in build.log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _read_batch(torch, rng, B, L, k):
    """B reads of L-4 bases (the quant path's round_up cut) plus edge rows."""
    import numpy as np

    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L - 4, np.int32)
    lengths[:4] = [0, k - 1, k, L]
    codes[4:12] = 0  # all-equal bases: every window the same hash
    codes[12:20] = np.tile(np.array([0, 1], np.uint8), L // 2)  # two hashes repeated
    for i, n in enumerate(lengths):
        codes[i, n:] = 0
    return torch.from_numpy(codes).to(DEVICE), torch.from_numpy(lengths).to(DEVICE)


def phase_kernels(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain, row_sort_wide
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_plane, sketch_all_k, sketch_batch

    rng = np.random.default_rng(SEED)
    cfg = QuantConfig()
    f = cfg.sketch_fraction
    for L in (104, 152):
        for k in (21, 31):
            codes, lengths = _read_batch(torch, rng, BATCH, L, k)
            caps = [cfg.sketch_capacity_for(k, L)] + ([4] if (L, k) == (104, 31) else [])
            for cap in caps:
                got = fused_sketch(codes, lengths, k, f, cap)
                want = sketch_batch(codes, lengths, k, f, cap)
                torch.cuda.synchronize()
                require(same_tensors(torch, got, want), f"K1 differs from sketch_batch at L={L} k={k} cap={cap}")
                if cap == 4:
                    require(int(got[2]) > 0, "cap 4 did not overflow")
                record(results, "K1", max_abs_err=max_err(got, want))
                ms, plain_ms = time_pair_ms(torch, lambda: fused_sketch(codes, lengths, k, f, cap),
                                            lambda: sketch_batch(codes, lengths, k, f, cap))
                print(f"[kernels] K1 B={BATCH} L={L} k={k} cap={cap}: bit-equal, overflow={int(got[2])}, "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    ks = (21, 31)
    for L in (104, 152):
        codes, lengths = _read_batch(torch, rng, BATCH, L, 31)
        for caps in [tuple(cfg.sketch_capacity_for(k, L) for k in ks)] + ([(4, 4)] if L == 104 else []):
            got = fused_sketch_multik(codes, lengths, ks, f, caps)
            want = sketch_all_k(codes, lengths, ks, f, caps)
            torch.cuda.synchronize()
            for g, w, k in zip(got, want, ks):
                require(same_tensors(torch, g, w), f"K2 differs from sketch_batch at L={L} k={k} caps={caps}")
                record(results, "K2", max_abs_err=max_err(g, w))
            overflow = [int(g[2]) for g in got]
            if caps == (4, 4):
                require(min(overflow) > 0, "caps (4, 4) did not overflow")
            ms, plain_ms = time_pair_ms(torch, lambda: fused_sketch_multik(codes, lengths, ks, f, caps),
                                        lambda: sketch_all_k(codes, lengths, ks, f, caps))
            print(f"[kernels] K2 B={BATCH} L={L} ks={ks} caps={caps}: bit-equal, overflow={overflow}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for B, L in ((BATCH, 2048), (1, (1 << 22) + 30)):
        if B == 1:  # one build chunk: the index build's row
            codes = torch.from_numpy(rng.integers(0, 4, size=(1, L)).astype(np.uint8)).to(DEVICE)
            lengths = torch.full((1,), L, dtype=torch.int32, device=DEVICE)
        else:
            codes, lengths = _read_batch(torch, rng, B, L, 31)
        got = nthash_sketch(codes, lengths, 31, f)
        want = hash_plane(codes, lengths, 31, f)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K3 differs from hash_plane at [{B}, {L}]")
        record(results, "K3", max_abs_err=max_err([got], [want]))
        ms, plain_ms = time_pair_ms(torch, lambda: nthash_sketch(codes, lengths, 31, f),
                                    lambda: hash_plane(codes, lengths, 31, f))
        print(f"[kernels] K3 [{B}, {L}] k=31: bit-equal, {int((got != 0xFFFFFFFF).sum())} kept windows, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del codes, lengths, got, want
    for name, dtype, lo, hi in (("K4", np.int32, -(2**31), 2**31 - 1), ("K4-int64", np.int64, -(2**63), 2**63 - 1)):
        for W in (2, 32, 256, 1024, 16384) if name == "K4" else (2, 8, 64, 256, 1024, 2048, 4096, 16384):
            x = torch.from_numpy(rng.integers(lo, hi, size=(BATCH, W), endpoint=True, dtype=dtype)).to(DEVICE)
            x[: BATCH // 4] = torch.from_numpy(rng.integers(0, 3, size=(BATCH // 4, W)).astype(dtype)).to(DEVICE)
            x[BATCH // 4 : BATCH // 4 + 16, ::2] = lo
            x[BATCH // 4 : BATCH // 4 + 16, 1::2] = hi
            got, want = row_sort(x), row_sort_plain(x)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"{name} differs from torch.sort at W={W}")
            record(results, name, max_abs_err=0)
            ms, plain_ms = time_pair_ms(torch, lambda: row_sort(x), lambda: row_sort_plain(x))
            print(f"[kernels] {name} B={BATCH} W={W}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            del x, got, want
    # row_sort_wide: K4-int64 over 16384-lane chunks + bitonic merges in torch.
    for B, W in ((BATCH, 1 << 15), (1024, 1 << 16)):
        x = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, size=(B, W), endpoint=True, dtype=np.int64)).to(DEVICE)
        x[:16] = torch.from_numpy(rng.integers(0, 3, size=(16, W)).astype(np.int64)).to(DEVICE)
        got, want = row_sort_wide(x), row_sort_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"row_sort_wide differs from torch.sort at [{B}, {W}]")
        del got, want
        ms, plain_ms = time_pair_ms(torch, lambda: row_sort_wide(x), lambda: row_sort_plain(x), reps=5)
        print(f"[kernels] row_sort_wide int64 [{B}, {W}]: bit-equal, K4-int64 chunks + merges {ms:.4f} ms, "
              f"torch.sort {plain_ms:.4f} ms")
        del x


def _csv_rows(path):
    return {r[0]: (float(r[1]), float(r[2])) for r in list(csv.reader(open(path)))[1:]}


def phase_sample():
    from sketch_rna_tpu_torch.cli import main as cli

    ex = ROOT / "examples"
    with tempfile.TemporaryDirectory() as tmp:
        idx, out64, out32 = (os.path.join(tmp, n) for n in ("sample.npz", "out64.csv", "out32.csv"))
        require(cli(["-o", "index", "-k", "31", str(ex / "sample.fa"), idx]) == 0, "index CLI failed")
        require(cli(["-o", "quant", "--em-dtype", "float64", idx, str(ex / "sample.fq"), out64]) == 0, "quant failed")
        require(cli(["-o", "quant", "--em-dtype", "float32", idx, str(ex / "sample.fq"), out32]) == 0, "quant failed")
        expected = (ex / "sample.expected.csv").read_bytes()
        require(Path(out64).read_bytes() == expected, "float64 CSV is not byte-identical to sample.expected.csv")
        a, b = _csv_rows(out32), _csv_rows(ex / "sample.expected.csv")
        require(a.keys() == b.keys(), "float32 CSV has another row set")
        rel = max(abs(x - y) / max(abs(y), 1e-9) for n in a for x, y in zip(a[n], b[n]))
        require(rel < 1e-4, f"float32 CSV max relative difference {rel}")
    print(f"[sample] float64 CSV byte-identical ({len(b)} rows); float32 max relative diff {rel:.3g}")


def phase_sample_multik():
    from sketch_rna_tpu_torch.cli import main as cli

    ex = ROOT / "examples"
    fa, fq = str(ex / "sample.fa"), str(ex / "sample.fq")
    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for dev, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            idx, out = os.path.join(tmp, f"{dev}.npz"), os.path.join(tmp, f"{dev}.csv")
            require(cli(["-o", "index", *extra, "-k", "21,31", fa, idx]) == 0, f"multi-k index CLI failed ({dev})")
            require(cli(["-o", "quant", *extra, "--em-dtype", "float64", idx, fq, out]) == 0,
                    f"multi-k quant CLI failed ({dev})")
            rows[dev] = _csv_rows(out)
        a, b = rows["cuda"], rows["cpu"]
        require(a.keys() == b.keys() and len(a) > 10, f"multi-k CSV row sets differ ({len(a)} vs {len(b)} rows)")
        rel = max(abs(x - y) / max(abs(y), 1e-300) for n in a for x, y in zip(a[n], b[n]))
        require(rel <= 1e-9, f"multi-k CSV on the card differs from the CPU run by {rel} relative")
    print(f"[sample-multik] -k 21,31 float64 CSV on the card == --device cpu run ({len(a)} rows, max rel diff {rel:.3g})")


def _records(seqs, prefix):
    import numpy as np

    from sketch_rna_tpu_torch.io.fasta import FastaRecords

    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    return FastaRecords([f"{prefix}{i:06d}" for i in range(len(seqs))], text, 0)


def _timed_quant(torch, tag, index, packed, config, n_reads):
    """Warm-up + timed quant; returns (result, seconds, launches of the timed
    run, its peak device memory in bytes)."""
    import numpy as np

    from sketch_rna_tpu_torch.pipeline import quantify

    t0 = time.perf_counter()
    quantify(index, packed, config)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up quant {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = quantify(index, packed, config)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] quant {n_reads} reads in {quant_s:.3f} s: {n_reads / quant_s:.1f} reads/s; "
          f"stages (s) {json.dumps({k: round(v, 4) for k, v in res.timing.items()})}; "
          f"peak device memory {peak} bytes")
    print(f"[{tag}] EM iterations {res.em_iterations}; mapped reads {res.num_mapped}; stats {json.dumps(res.stats)}; "
          f"launches {json.dumps(launches)}")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * n_reads, f"only {res.num_mapped} reads mapped")
    require(res.stats["sketch_overflow"] == 0 and res.stats["expand_dropped"] == 0,
            f"dropped work: {res.stats}")
    return res, quant_s, launches, peak


def _first_batch(torch, tag, index, config, codes, lengths, L):
    """The first batch through the kernels and through the plain functions:
    equal tables.  Returns the int32 and int64 rows the kernels' K4 sorted."""
    import numpy as np

    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.pipeline import sketch_match_step
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k

    c = torch.from_numpy(np.ascontiguousarray(codes[:BATCH, :L])).to(DEVICE)
    n = torch.from_numpy(lengths[:BATCH]).to(DEVICE)
    B = c.shape[0]
    caps = tuple(config.sketch_capacity_for(k, L) for k in index.kmer_lengths)
    sorted_rows = {torch.int32: [], torch.int64: []}

    def recording_sort(x):
        sorted_rows[x.dtype].append(x.clone())
        return row_sort(x)

    got = sketch_match_step(c, n, index, config, caps, sort=recording_sort)
    want = sketch_match_step(c, n, index, config, caps, sketch=sketch_all_k, sort=row_sort_plain)
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
    require(same, f"{tag} first batch: kernel candidate tables differ from the plain functions'")
    print(f"[{tag}] first batch [{B}, {L}] caps {caps}: kernel tables == plain tables "
          f"({int(got.mask.sum())} candidates)")
    return c, n, caps, sorted_rows


def phase_scale(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch
    from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

    (n_tx, n_reads), read_len = SCALE, 100
    seqs = synth_transcriptome(np.random.default_rng(SEED), n_tx, 600, 2500)
    config = QuantConfig(batch_size=BATCH, em_dtype="float32")
    t0 = time.perf_counter()
    artifact = build_index(_records(seqs, "SYN"), config, device=DEVICE)
    kidx = artifact.per_k[31]
    print(f"[scale] index: {n_tx} transcripts, {sum(s.size for s in seqs)} bases -> {kidx.num_keys} keys, "
          f"{kidx.postings.size} postings in {time.perf_counter() - t0:.3f} s on the card")
    index = to_device(artifact, DEVICE)
    codes, lengths = sample_reads(seqs, n_reads, read_len, 256, seed=SEED)
    _, _, launches, _ = _timed_quant(torch, "scale", index, PackedReads(codes, lengths, []), config, n_reads)
    require(launches["K1"] > 0 and launches["K4"] > 0, f"the single-k path skipped a kernel: {launches}")
    require(launches["K2"] == launches["K3"] == 0, f"the single-k path ran a multi-k or long-read kernel: {launches}")

    L = 104  # round_up(100, 8): the width the quant path cut these reads to
    c, n, (cap,), rows = _first_batch(torch, "scale", index, config, codes, lengths, L)
    key = rows[torch.int32][0]  # the event grouping sort
    f = config.sketch_fraction
    k1 = time_pair_ms(torch, lambda: fused_sketch(c, n, 31, f, cap), lambda: sketch_batch(c, n, 31, f, cap))
    k4 = time_pair_ms(torch, lambda: row_sort(key), lambda: row_sort_plain(key))
    print(f"[scale] main-path shapes: K1 [{BATCH}, {L}] cap {cap}: kernel {k1[0]:.4f} ms, plain {k1[1]:.4f} ms; "
          f"K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.4f} ms, plain {k4[1]:.4f} ms")
    record(results, "K1", launches=launches["K1"], ms=round(k1[0], 5), plain_ms=round(k1[1], 5),
           shape=f"[{BATCH}, {L}] k=31 cap {cap}")


def c3_problem(torch, ctx):
    """The JAX package's bench config c3_chr20_multik (bench.py:286-289):
    20,000 transcripts (synth_transcriptome, seed 22), index built on the
    card, 2^21 reads of 100 bp (seed 22, padded to 128); built once."""
    if "c3" in ctx:
        return ctx["c3"]
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

    (n_tx, n_reads), ks = SCALE_MULTIK, (21, 31)
    seqs = synth_transcriptome(np.random.default_rng(22), n_tx)
    config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=128, em_dtype="float32")
    reset_launches()
    t0 = time.perf_counter()
    artifact = build_index(_records(seqs, "T"), config, device=DEVICE)
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    print(f"[c3] index: {n_tx} transcripts, {sum(s.size for s in seqs)} bases -> "
          + ", ".join(f"k={k}: {artifact.per_k[k].num_keys} keys, {artifact.per_k[k].postings.size} postings"
                      for k in ks)
          + f" in {build_s:.3f} s on the card; launches {json.dumps(build_launches)}")
    require(build_launches["K3"] > 0, "the index build did not hash through K3")
    codes, lengths = sample_reads(seqs, n_reads, 100, config.max_read_len, seed=22)
    ctx["c3"] = dict(seqs=seqs, artifact=artifact, index=to_device(artifact, DEVICE), codes=codes,
                     lengths=lengths, config=config)
    return ctx["c3"]


def phase_scale_multik(torch, results, ctx):
    """The c3_chr20_multik stand-in cut to 2^21 reads, the fused bound."""
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch_multik
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k

    c3 = c3_problem(torch, ctx)
    index, codes, lengths, config = c3["index"], c3["codes"], c3["lengths"], c3["config"]
    ks, n_reads = config.kmer_lengths, lengths.size
    _, _, launches, ctx["fused_peak_bytes"] = _timed_quant(torch, "scale-multik", index,
                                                           PackedReads(codes, lengths, []), config, n_reads)
    require(launches["K2"] > 0 and launches["K4"] > 0 and launches["K4-int64"] > 0,
            f"the multi-k path skipped a kernel: {launches}")

    L = 104
    c, n, caps, rows = _first_batch(torch, "scale-multik", index, config, codes, lengths, L)
    f = config.sketch_fraction
    k2 = time_pair_ms(torch, lambda: fused_sketch_multik(c, n, ks, f, caps), lambda: sketch_all_k(c, n, ks, f, caps))
    key = max(rows[torch.int32], key=lambda x: x.shape[1])  # the widest int32 sort of the batch
    tables = rows[torch.int64][0]  # the (tid << 32) | score rows of the combine
    k4 = time_pair_ms(torch, lambda: row_sort(key), lambda: row_sort_plain(key))
    k4w = time_pair_ms(torch, lambda: row_sort(tables), lambda: row_sort_plain(tables))
    print(f"[scale-multik] main-path shapes: K2 [{BATCH}, {L}] ks {ks} caps {caps}: kernel {k2[0]:.4f} ms, "
          f"plain {k2[1]:.4f} ms; K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.4f} ms, plain {k4[1]:.4f} ms; "
          f"K4-int64 [{BATCH}, {tables.shape[1]}]: kernel {k4w[0]:.4f} ms, plain {k4w[1]:.4f} ms")
    record(results, "K2", launches=launches["K2"], ms=round(k2[0], 5), plain_ms=round(k2[1], 5),
           shape=f"[{BATCH}, {L}] ks {ks} caps {caps}")
    record(results, "K4", launches=launches["K4"], ms=round(k4[0], 5), plain_ms=round(k4[1], 5),
           shape=f"[{BATCH}, {key.shape[1]}] int32 event keys")
    record(results, "K4-int64", launches=launches["K4-int64"], ms=round(k4w[0], 5), plain_ms=round(k4w[1], 5),
           shape=f"[{BATCH}, {tables.shape[1]}] int64 (tid << 32) | score")


def phase_spill(torch):
    """Per-k table spill on the card: the batch regroups merged, equal to a forced merged run."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import match_rows, quantify

    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 80).astype(np.uint8)
    seqs = [np.concatenate([core, rng.integers(0, 4, 60).astype(np.uint8)]) for _ in range(300)]
    config = QuantConfig(kmer_lengths=(15, 31), candidate_capacity=8, batch_size=32, em_dtype="float64")
    index = to_device(build_index(_records(seqs, "T"), config, device=DEVICE), DEVICE)
    codes = np.zeros((48, 128), np.uint8)
    codes[:32, :70] = core[:70]
    for i in range(32, 48):
        codes[i, :70] = seqs[i][70:140]
    packed = PackedReads(codes, np.full(48, 70, np.int32), [])
    merged = dataclasses.replace(config, match_per_k_tables=False)
    tid, score, _, stats = match_rows(index, torch.from_numpy(codes), packed.lengths, config)
    m_tid, m_score, _, m_stats = match_rows(index, torch.from_numpy(codes), packed.lengths, merged)
    require(int(stats["candidate_spilled_per_k"]) > 0, "the per-k tables did not spill")
    require(torch.equal(tid, m_tid) and torch.equal(score, m_score), "regrouped tables differ from the merged run")
    require(int(stats["candidate_spilled"]) == int(m_stats["candidate_spilled"]) > 0, "candidate_spilled differs")
    a, b = quantify(index, packed, config), quantify(index, packed, merged)
    require(np.array_equal(a.has_entry, b.has_entry) and np.allclose(a.pi, b.pi, rtol=1e-9, atol=0),
            "spill quant differs from the forced merged quant")
    print(f"[spill] per-k spill {int(stats['candidate_spilled_per_k'])} -> merged regroup; tables == forced "
          f"merged run; candidate_spilled {int(stats['candidate_spilled'])}")


def phase_long_reads(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_plane
    from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

    (n_tx, n_reads), read_len = LONG_READS, 2000
    seqs = synth_transcriptome(np.random.default_rng(SEED + 1), n_tx, 3000, 8000)
    config = QuantConfig(batch_size=BATCH, em_dtype="float32")
    index = to_device(build_index(_records(seqs, "L"), config, device=DEVICE), DEVICE)
    # Reads from the transcripts that hold a whole read: every read has
    # 1970 windows at k = 31, so none takes the fused kernels.
    long_enough = [s for s in seqs if s.size >= read_len]
    codes, lengths = sample_reads(long_enough, n_reads, read_len, 2048, seed=SEED + 1)
    require(int(lengths.min()) == read_len, "a long-read sample is shorter than the read length")
    _, _, launches, _ = _timed_quant(torch, "long-reads", index, PackedReads(codes, lengths, []), config, n_reads)
    require(launches["K3"] > 0 and launches["K4-int64"] > 0 and launches["K1"] == 0,
            f"long reads did not sketch through K3 + K4-int64 alone: {launches}")
    L = read_len  # round_up(2000, 8)
    c, n, caps, _ = _first_batch(torch, "long-reads", index, config, codes, lengths, L)
    k3 = time_pair_ms(torch, lambda: nthash_sketch(c, n, 31, config.sketch_fraction),
                      lambda: hash_plane(c, n, 31, config.sketch_fraction))
    print(f"[long-reads] main-path shape: K3 [{BATCH}, {L}] k=31: kernel {k3[0]:.4f} ms, plain {k3[1]:.4f} ms")
    record(results, "K3", launches=launches["K3"], ms=round(k3[0], 5), plain_ms=round(k3[1], 5),
           shape=f"[{BATCH}, {L}] k=31")
    del c, n

    # Reads past K4's 16384 windows: the dedup sorts through row_sort_wide.
    n_tx, n_reads, read_len = VERY_LONG
    seqs = synth_transcriptome(np.random.default_rng(SEED + 2), n_tx, read_len, read_len + 4000)
    index = to_device(build_index(_records(seqs, "V"), config, device=DEVICE), DEVICE)
    codes, lengths = sample_reads([s for s in seqs if s.size >= read_len], n_reads, read_len, read_len,
                                  seed=SEED + 2)
    require(int(lengths.min()) == read_len, "a very long read is shorter than the read length")
    _, _, launches, _ = _timed_quant(torch, "very-long-reads", index, PackedReads(codes, lengths, []), config,
                                        n_reads)
    require(launches["K3"] > 0 and launches["K4-int64"] > 0 and launches["K1"] == 0,
            f"20 kb reads did not sketch through K3 + K4-int64 alone: {launches}")
    _first_batch(torch, "very-long-reads", index, config, codes, lengths, read_len)


def _rel_diff(a, b) -> float:
    import numpy as np

    scale = np.maximum(np.abs(b), 1e-300)
    return float(np.max(np.abs(a - b) / scale)) if a.size else 0.0


def phase_stream(torch, ctx):
    """The streamed engine on the card equals the fused one (float64)."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import quantify
    from sketch_rna_tpu_torch.stream import quantify_streamed

    c3 = c3_problem(torch, ctx)
    config = dataclasses.replace(c3["config"], em_dtype="float64")
    packed = PackedReads(c3["codes"], c3["lengths"], [])
    t0 = time.perf_counter()
    fused = quantify(c3["index"], packed, config)
    print(f"[stream] fused float64 quant of {packed.num_reads} reads: {time.perf_counter() - t0:.3f} s, "
          f"{fused.em_iterations} EM iterations")
    variants = {
        "default knobs": config,
        "class buffer 2^16 rows": dataclasses.replace(config, stream_class_capacity=1 << 16),
        "one full-width buffer": dataclasses.replace(config, stream_narrow_width=0),
    }
    for name, cfg in variants.items():
        t0 = time.perf_counter()
        res = quantify_streamed(c3["index"], packed, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = res.stats
        rel = max(_rel_diff(res.pi, fused.pi), _rel_diff(res.weighted_counts, fused.weighted_counts))
        print(f"[stream] {name}: {secs:.3f} s, {st['stream_classes']} classes, {st['stream_compactions']} "
              f"compactions, {st['stream_drains']} drains, class_overflow {st['class_overflow']}, "
              f"wide_spilled {st['wide_spilled']}; max relative difference to fused {rel:.3g}")
        require(np.array_equal(res.has_entry, fused.has_entry), f"streamed ({name}) CSV rows differ from fused")
        require(res.em_iterations == fused.em_iterations, f"streamed ({name}) EM iterations differ")
        require(rel <= 1e-9, f"streamed ({name}) differs from fused by {rel} relative")
        require(st["class_overflow"] == 0 and st["wide_spilled"] == 0, f"streamed ({name}) dropped classes")
        if cfg.stream_class_capacity == 1 << 16:
            require(st["stream_drains"] > 0, "the 2^16-row class buffer never drained")


def _c3_chunks(seqs, n_reads, chunk, seed):
    """2-bit chunks of 100 bp reads, made chunk by chunk from seed + c."""
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    for c, r0 in enumerate(range(0, n_reads, chunk)):
        codes, lengths = sample_reads(seqs, min(chunk, n_reads - r0), 100, 104, seed=seed + c)
        yield PackedReads(codes, lengths, []).bit_packed()


def phase_stream_c3(torch, ctx):
    """BASELINE config 3 at 10M reads through the streamed engine."""
    import numpy as np

    from sketch_rna_tpu_torch.stream import quantify_streamed

    c3 = c3_problem(torch, ctx)
    index, config, seqs = c3["index"], c3["config"], c3["seqs"]
    chunk = config.stream_chunk_reads
    t0 = time.perf_counter()
    quantify_streamed(index, _c3_chunks(seqs, chunk, chunk, 7000), config, num_reads_hint=chunk)
    torch.cuda.synchronize()
    print(f"[stream-c3] warm-up: {chunk} reads streamed in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = quantify_streamed(index, _c3_chunks(seqs, C3_READS, chunk, 9000), config, num_reads_hint=C3_READS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    st = res.stats
    print(f"[stream-c3] quant {C3_READS} reads in {secs:.3f} s: {C3_READS / secs:.1f} reads/s (feed made on the "
          f"host inside the timing); stages (s) {json.dumps({k: round(v, 4) for k, v in res.timing.items()})}")
    print(f"[stream-c3] {st['stream_classes']} classes, {st['stream_compactions']} compactions, "
          f"{st['stream_drains']} drains; stats {json.dumps(st)}; EM iterations {res.em_iterations}; "
          f"mapped reads {res.num_mapped}; launches {json.dumps(launches)}")
    print(f"[stream-c3] peak device memory {peak} bytes (fused 2^21-read run: {ctx.get('fused_peak_bytes')})")
    require(res.num_reads == C3_READS, f"{res.num_reads} reads quantified")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    for key in ("sketch_overflow", "expand_dropped", "candidate_spilled", "class_overflow", "wide_spilled"):
        require(st[key] == 0, f"stream-c3 lost work: {key}={st[key]}")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * C3_READS, f"only {res.num_mapped} reads mapped")
    require(launches["K2"] > 0 and launches["K4"] > 0 and launches["K4-int64"] > 0,
            f"the streamed multi-k path skipped a kernel: {launches}")


def _write_fastq(path, codes, lengths):
    """Fixed-width FASTQ records, written with numpy: @r<9 digits>, the
    read, +, a quality line of I."""
    import numpy as np

    n, L = codes.shape[0], int(lengths[0])
    require(bool((lengths == L).all()), "the FASTQ writer takes reads of one length")
    head = np.frombuffer(b"".join(b"@r%09d\n" % i for i in range(n)), np.uint8).reshape(n, 12)
    rec = np.empty((n, 12 + L + 3 + L + 1), np.uint8)
    rec[:, :12] = head
    rec[:, 12 : 12 + L] = np.frombuffer(b"ACGT", np.uint8)[codes[:, :L]]
    rec[:, 12 + L : 15 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 15 + L : 15 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def phase_cli_stream(torch, ctx):
    """The CLI past the fused bound: the streamed route over the native scan."""
    import contextlib
    import io

    import numpy as np

    from sketch_rna_tpu_torch.cli import main as cli
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.stream import quantify_streamed
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    c3 = c3_problem(torch, ctx)
    t0 = time.perf_counter()
    has_native = native.native_available()
    print(f"[cli-stream] native FASTQ parser: {'built' if has_native else 'DID NOT BUILD'} "
          f"({time.perf_counter() - t0:.2f} s)")
    extra = [] if has_native else ["--no-native"]
    if not has_native:
        print("[cli-stream] make -C native failed on this machine: running the CLI with --no-native "
              "(the Python parser's whole-file pack, then the streamed engine)")
    codes, lengths = sample_reads(c3["seqs"], CLI_READS, 100, 104, seed=31)
    with tempfile.TemporaryDirectory() as tmp:
        fq, idx, out = (os.path.join(tmp, n) for n in ("reads.fq", "c3.npz", "out.csv"))
        t0 = time.perf_counter()
        _write_fastq(fq, codes, lengths)
        save_index(idx, c3["artifact"])
        print(f"[cli-stream] wrote {CLI_READS} reads ({os.path.getsize(fq)} bytes) in "
              f"{time.perf_counter() - t0:.2f} s")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli(["-o", "quant", *extra, idx, fq, out])
        secs = time.perf_counter() - t0
        route = [line for line in err.getvalue().splitlines() if line.startswith("quant route:")]
        print(f"[cli-stream] CLI quant in {secs:.3f} s ({CLI_READS / secs:.1f} reads/s, parse included): {route}")
        require(rc == 0, f"CLI quant failed: {err.getvalue()[-2000:]}")
        want = f"quant route: streamed, feed: {'native-scan' if has_native else 'python'}"
        require(route == [want], f"the CLI took another route: {route}, expected {want!r}")
        got = _csv_rows(out)
    ref = quantify_streamed(c3["index"], PackedReads(codes, lengths, []), c3["config"])
    want_rows = {ref.names[t]: (float(ref.weighted_counts[t]), float(ref.pi[t]))
                 for t in np.flatnonzero(ref.has_entry)}
    require(got.keys() == want_rows.keys(), f"CLI CSV rows ({len(got)}) != in-process rows ({len(want_rows)})")
    rel = max(abs(x - y) / max(abs(y), 1e-9) for n in got for x, y in zip(got[n], want_rows[n]))
    require(rel <= 1e-4, f"CLI CSV differs from in-process quantify_streamed by {rel} relative")
    print(f"[cli-stream] CSV == in-process quantify_streamed ({len(got)} rows, max rel diff {rel:.3g})")


def phase_samples():
    """Multi-sample, TPM, refbin and EM checkpoints on examples/."""
    import shutil

    import numpy as np

    from sketch_rna_tpu_torch.cli import main as cli
    from sketch_rna_tpu_torch.index.refbin import load_any_index

    ex = ROOT / "examples"
    expected = (ex / "sample.expected.csv").read_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        fqs = []
        for name in ("a", "b"):
            fqs.append(os.path.join(tmp, f"{name}.fq"))
            shutil.copy(ex / "sample.fq", fqs[-1])
        for fmt in ("refbin", "npz"):
            idx = os.path.join(tmp, f"sample.{fmt}")
            require(cli(["-o", "index", "--index-format", fmt, str(ex / "sample.fa"), idx]) == 0, f"{fmt} index failed")
            out = os.path.join(tmp, f"{fmt}.csv")
            require(cli(["-o", "quant", "--tpm", "--em-dtype", "float64", idx, ",".join(fqs), out]) == 0,
                    f"multi-sample quant failed ({fmt})")
            lengths = np.asarray(load_any_index(idx).lengths, np.float64)
            names = load_any_index(idx).names
            for name in ("a", "b"):
                lines = Path(os.path.join(tmp, f"{fmt}.{name}.csv")).read_text().splitlines()
                three = "".join(",".join(line.split(",")[:3]) + "\n" for line in lines)
                require(three.encode() == expected, f"{fmt} sample {name}: first three columns differ from expected")
                rows = [line.split(",") for line in lines[1:]]
                counts = np.zeros(len(names))
                for r in rows:
                    counts[names.index(r[0])] = float(r[1])
                rate = counts / np.maximum(lengths, 1.0)
                tpm = rate / rate.sum() * 1e6
                rel = max(abs(float(r[3]) - tpm[names.index(r[0])]) / tpm[names.index(r[0])] for r in rows)
                require(lines[0].endswith(",TPM") and rel < 1e-5, f"TPM column off by {rel} relative")
        idx = os.path.join(tmp, "sample.npz")
        ckpt = os.path.join(tmp, "em.ckpt.npz")
        base = ["-o", "quant", "--em-dtype", "float64", idx, str(ex / "sample.fq")]
        require(cli([*base[:-2], "--em-max-iterations", "2", "--em-checkpoint", ckpt, *base[-2:],
                     os.path.join(tmp, "killed.csv")]) == 0, "checkpointed quant failed")
        require(cli([*base[:-2], "--em-checkpoint", ckpt, *base[-2:], os.path.join(tmp, "resumed.csv")]) == 0,
                "resumed quant failed")
        require(cli([*base, os.path.join(tmp, "oneshot.csv")]) == 0, "one-shot quant failed")
        resumed = Path(os.path.join(tmp, "resumed.csv")).read_bytes()
        require(resumed == Path(os.path.join(tmp, "oneshot.csv")).read_bytes() == expected,
                "resumed EM CSV differs from the one-shot run")
    print("[samples] refbin + npz indexes; two-sample --tpm quant: first three columns byte-identical to "
          f"sample.expected.csv, TPM = recompute (max rel diff {rel:.3g}); EM stopped after 2 iterations and "
          "resumed == one-shot, byte for byte")


def profile_stream(torch, ctx):
    """One steady streamed quant of the scale-multik reads under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.stream import quantify_streamed

    c3 = c3_problem(torch, ctx)
    packed = PackedReads(c3["codes"], c3["lengths"], []).bit_packed()
    quantify_streamed(c3["index"], packed, c3["config"])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = quantify_streamed(c3["index"], packed, c3["config"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # before the profiler's own teardown
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0, None
    for a, b in spans:  # union of device intervals, in microseconds
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    print(f"[profile] streamed quant of {packed.num_reads} reads: wall {wall:.4f} s traced, stages "
          f"{json.dumps({k: round(v, 4) for k, v in res.timing.items()})}; {len(events)} device operations, "
          f"busy {busy / 1e3:.2f} ms: idle {100 * (1 - busy / 1e6 / wall):.1f}%")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    print(table)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES), help=f"comma list of {', '.join(PHASES)}")
    parser.add_argument("--profile", action="store_true",
                        help="last, trace one steady streamed quant with torch.profiler")
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sketch_rna_tpu_torch

    require(
        Path(sketch_rna_tpu_torch.__file__).resolve().parent == ROOT / "sketch_rna_tpu_torch",
        "run chip_smoke.py from a checkout that holds sketch_rna_tpu_torch/",
    )
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    results = {name: {"name": fn, "route": "cuda", "source": src, "replaces": rep}
               for name, (fn, src, rep) in KERNELS.items()}
    ctx = {}  # data that several phases share (the c3 index and reads)
    runs = {
        "kernels": lambda: phase_kernels(torch, results),
        "sample": phase_sample,
        "sample-multik": phase_sample_multik,
        "scale": lambda: phase_scale(torch, results),
        "scale-multik": lambda: phase_scale_multik(torch, results, ctx),
        "spill": lambda: phase_spill(torch),
        "long-reads": lambda: phase_long_reads(torch, results),
        "stream": lambda: phase_stream(torch, ctx),
        "stream-c3": lambda: phase_stream_c3(torch, ctx),
        "cli-stream": lambda: phase_cli_stream(torch, ctx),
        "samples": phase_samples,
    }
    for phase in PHASES:
        if phase in phases:
            t0 = time.perf_counter()
            runs[phase]()
            print(f"[{phase}] phase done in {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_stream(torch, ctx)
    if set(phases) == set(PHASES):
        missing = [n for n, r in results.items() if not r.get("launches") or "ms" not in r]
        require(not missing, f"kernels without a main-path launch or time: {missing}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
