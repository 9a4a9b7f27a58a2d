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
                1024 windows sketch through K3 + K4-int64 alone.

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
PHASES = ("kernels", "sample", "sample-multik", "scale", "scale-multik", "spill", "long-reads")
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
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
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
    """Warm-up + timed quant; returns (result, seconds, launches of the timed run)."""
    import numpy as np

    from sketch_rna_tpu_torch.pipeline import quantify

    t0 = time.perf_counter()
    quantify(index, packed, config)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up quant {time.perf_counter() - t0:.3f} s")
    reset_launches()
    t0 = time.perf_counter()
    res = quantify(index, packed, config)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] quant {n_reads} reads in {quant_s:.3f} s: {n_reads / quant_s:.1f} reads/s; "
          f"stages (s) {json.dumps({k: round(v, 4) for k, v in res.timing.items()})}")
    print(f"[{tag}] EM iterations {res.em_iterations}; mapped reads {res.num_mapped}; stats {json.dumps(res.stats)}; "
          f"launches {json.dumps(launches)}")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * n_reads, f"only {res.num_mapped} reads mapped")
    require(res.stats["sketch_overflow"] == 0 and res.stats["expand_dropped"] == 0,
            f"dropped work: {res.stats}")
    return res, quant_s, launches


def _first_batch(torch, tag, index, config, codes, lengths, L):
    """The first batch through the kernels and through the plain functions:
    equal tables.  Returns the int32 and int64 rows the kernels' K4 sorted."""
    import numpy as np

    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.pipeline import sketch_match_step
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k

    c = torch.from_numpy(np.ascontiguousarray(codes[:BATCH, :L])).to(DEVICE)
    n = torch.from_numpy(lengths[:BATCH]).to(DEVICE)
    caps = tuple(config.sketch_capacity_for(k, L) for k in index.kmer_lengths)
    sorted_rows = {torch.int32: [], torch.int64: []}

    def recording_sort(x):
        sorted_rows[x.dtype].append(x.clone())
        return row_sort(x)

    got = sketch_match_step(c, n, index, config, caps, sort=recording_sort)
    want = sketch_match_step(c, n, index, config, caps, sketch=sketch_all_k, sort=row_sort_plain)
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
    require(same, f"{tag} first batch: kernel candidate tables differ from the plain functions'")
    print(f"[{tag}] first batch [{BATCH}, {L}] caps {caps}: kernel tables == plain tables "
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
    _, _, launches = _timed_quant(torch, "scale", index, PackedReads(codes, lengths, []), config, n_reads)
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


def phase_scale_multik(torch, results):
    """The JAX package's bench config c3_chr20_multik (bench.py:286-289)."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch_multik
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k
    from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

    (n_tx, n_reads), read_len, ks = SCALE_MULTIK, 100, (21, 31)
    seqs = synth_transcriptome(np.random.default_rng(22), n_tx)
    config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=128, em_dtype="float32")
    reset_launches()
    t0 = time.perf_counter()
    artifact = build_index(_records(seqs, "T"), config, device=DEVICE)
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    print(f"[scale-multik] index: {n_tx} transcripts, {sum(s.size for s in seqs)} bases -> "
          + ", ".join(f"k={k}: {artifact.per_k[k].num_keys} keys, {artifact.per_k[k].postings.size} postings"
                      for k in ks)
          + f" in {build_s:.3f} s on the card; launches {json.dumps(build_launches)}")
    require(build_launches["K3"] > 0, "the index build did not hash through K3")
    index = to_device(artifact, DEVICE)
    codes, lengths = sample_reads(seqs, n_reads, read_len, config.max_read_len, seed=22)
    _, _, launches = _timed_quant(torch, "scale-multik", index, PackedReads(codes, lengths, []), config,
                                          n_reads)
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
    from sketch_rna_tpu_torch.pipeline import _match_tables, quantify

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
    tid, score, _, stats = _match_tables(index, packed, config)
    m_tid, m_score, _, m_stats = _match_tables(index, packed, merged)
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
    _, _, launches = _timed_quant(torch, "long-reads", index, PackedReads(codes, lengths, []), config, n_reads)
    require(launches["K3"] > 0 and launches["K4-int64"] > 0 and launches["K1"] == 0,
            f"long reads did not sketch through K3 + K4-int64 alone: {launches}")
    L = read_len  # round_up(2000, 8)
    c, n, caps, _ = _first_batch(torch, "long-reads", index, config, codes, lengths, L)
    k3 = time_pair_ms(torch, lambda: nthash_sketch(c, n, 31, config.sketch_fraction),
                      lambda: hash_plane(c, n, 31, config.sketch_fraction))
    print(f"[long-reads] main-path shape: K3 [{BATCH}, {L}] k=31: kernel {k3[0]:.4f} ms, plain {k3[1]:.4f} ms")
    record(results, "K3", launches=launches["K3"], ms=round(k3[0], 5), plain_ms=round(k3[1], 5),
           shape=f"[{BATCH}, {L}] k=31")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES), help=f"comma list of {', '.join(PHASES)}")
    phases = [p for p in parser.parse_args().phases.split(",") if p]
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
    runs = {
        "kernels": lambda: phase_kernels(torch, results),
        "sample": phase_sample,
        "sample-multik": phase_sample_multik,
        "scale": lambda: phase_scale(torch, results),
        "scale-multik": lambda: phase_scale_multik(torch, results),
        "spill": lambda: phase_spill(torch),
        "long-reads": lambda: phase_long_reads(torch, results),
    }
    for phase in PHASES:
        if phase in phases:
            t0 = time.perf_counter()
            runs[phase]()
            print(f"[{phase}] phase done in {time.perf_counter() - t0:.1f} s")
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
