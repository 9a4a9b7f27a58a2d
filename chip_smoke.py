#!/usr/bin/env python3
"""Drive the PyTorch port (sketch_rna_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the script exits nonzero
without printing its result line:

  1. device  — torch / CUDA versions, the card's name and power limit;
  2. build   — nvcc builds the kernels in csrc/ (seconds);
  3. kernels — K1 (fused sketch) and K4 (row sort) against their plain
               PyTorch versions on the card, bit for bit, with times;
  4. sample  — the port's CLI on examples/sample.{fa,fq}: the float64 CSV
               is byte-identical to examples/sample.expected.csv, the
               float32 CSV within 1e-4 relative;
  5. scale   — 6,000 synthetic isoform-family transcripts + 1,000,000
               reads of 100 bp, k=31, batch 8192, float32 EM: index build
               on the card, one warm-up and one timed quant (reads/s),
               kernel launch counts of the timed quant, read-count
               conservation, and the first batch's candidate tables
               against the plain functions on the same batch.

Then one JSON line per kernel ({"kernels": [...]}), the nvidia-smi line
of the card, and last {"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

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
SEED = 1234
BATCH = 8192


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
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _k1_batch(torch, rng, L, k):
    """B reads of L-4 bases (the quant path's round_up cut) plus edge rows."""
    import numpy as np

    codes = rng.integers(0, 4, size=(BATCH, L)).astype(np.uint8)
    lengths = np.full(BATCH, L - 4, np.int32)
    lengths[:4] = [0, k - 1, k, L]
    codes[4:12] = 0  # all-equal bases: every window the same hash
    codes[12:20] = np.tile(np.array([0, 1], np.uint8), L // 2)  # two hashes repeated
    for i, n in enumerate(lengths):
        codes[i, n:] = 0
    return torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda()


def phase_kernels(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch

    rng = np.random.default_rng(SEED)
    cfg = QuantConfig()
    k1_err = 0
    for L in (104, 152):
        for k in (21, 31):
            codes, lengths = _k1_batch(torch, rng, L, k)
            caps = [cfg.sketch_capacity_for(k, L)] + ([4] if (L, k) == (104, 31) else [])
            for cap in caps:
                got = fused_sketch(codes, lengths, k, cfg.sketch_fraction, cap)
                want = sketch_batch(codes, lengths, k, cfg.sketch_fraction, cap)
                torch.cuda.synchronize()
                err = int((got[0] - want[0]).abs().max())
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                same = same and int(got[2]) == int(want[2])
                require(same, f"K1 differs from sketch_batch at L={L} k={k} cap={cap}")
                if cap == 4:
                    require(int(got[2]) > 0, "cap 4 did not overflow")
                k1_err = max(k1_err, err)
                ms, plain_ms = time_pair_ms(
                    torch,
                    lambda: fused_sketch(codes, lengths, k, cfg.sketch_fraction, cap),
                    lambda: sketch_batch(codes, lengths, k, cfg.sketch_fraction, cap),
                )
                print(
                    f"[kernels] K1 B={BATCH} L={L} k={k} cap={cap}: bit-equal, overflow={int(got[2])}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                )
    k4_err = 0
    for W in (2, 32, 256, 1024, 16384):
        x = torch.from_numpy(
            rng.integers(-(2**31), 2**31 - 1, size=(BATCH, W), endpoint=True).astype(np.int32)
        ).cuda()
        x[: BATCH // 4] = torch.from_numpy(rng.integers(0, 3, size=(BATCH // 4, W)).astype(np.int32)).cuda()
        x[BATCH // 4 : BATCH // 4 + 16, ::2] = -(2**31)
        x[BATCH // 4 : BATCH // 4 + 16, 1::2] = 2**31 - 1
        got, want = row_sort(x), row_sort_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K4 differs from torch.sort at W={W}")
        k4_err = max(k4_err, int((got.long() - want.long()).abs().max()))
        ms, plain_ms = time_pair_ms(torch, lambda: row_sort(x), lambda: row_sort_plain(x))
        print(f"[kernels] K4 B={BATCH} W={W}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del x, got, want
    results["K1"]["max_abs_err"] = k1_err
    results["K4"]["max_abs_err"] = k4_err


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

        def rows(path):
            return {r[0]: (float(r[1]), float(r[2])) for r in list(csv.reader(open(path)))[1:]}

        a, b = rows(out32), rows(ex / "sample.expected.csv")
        require(a.keys() == b.keys(), "float32 CSV has another row set")
        rel = max(abs(x - y) / max(abs(y), 1e-9) for n in a for x, y in zip(a[n], b[n]))
        require(rel < 1e-4, f"float32 CSV max relative difference {rel}")
    print(f"[sample] float64 CSV byte-identical ({len(b)} rows); float32 max relative diff {rel:.3g}")


def phase_scale(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import FastaRecords
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.probe import probe
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.match.rowmatch import row_expand_from_runs
    from sketch_rna_tpu_torch.pipeline import quantify, sketch_match_step
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch
    from sketch_rna_tpu_torch.utils.synth import sample_reads, synth_transcriptome

    n_tx, n_reads, read_len = 6000, 1_000_000, 100
    seqs = synth_transcriptome(np.random.default_rng(SEED), n_tx, 600, 2500)
    text = [np.frombuffer(b"ACGT", np.uint8)[s].tobytes().decode() for s in seqs]
    records = FastaRecords([f"SYN{i:05d}" for i in range(n_tx)], text, 0)
    config = QuantConfig(batch_size=BATCH, em_dtype="float32")

    t0 = time.perf_counter()
    artifact = build_index(records, config, device="cuda")
    index_s = time.perf_counter() - t0
    kidx = artifact.per_k[31]
    print(f"[scale] index: {n_tx} transcripts, {sum(s.size for s in seqs)} bases -> {kidx.num_keys} keys, "
          f"{kidx.postings.size} postings in {index_s:.3f} s on the card")
    index = to_device(artifact, "cuda")

    codes, lengths = sample_reads(seqs, n_reads, read_len, 256, seed=SEED)
    packed = PackedReads(codes, lengths, [])
    t0 = time.perf_counter()
    quantify(index, packed, config)
    torch.cuda.synchronize()
    print(f"[scale] warm-up quant {time.perf_counter() - t0:.3f} s")

    fused_sketch.launches = 0
    row_sort.launches = 0
    t0 = time.perf_counter()
    res = quantify(index, packed, config)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    launches = {"K1": fused_sketch.launches, "K4": row_sort.launches}

    print(f"[scale] quant {n_reads} reads in {quant_s:.3f} s: {n_reads / quant_s:.1f} reads/s; "
          f"stages (s) {json.dumps({k: round(v, 4) for k, v in res.timing.items()})}")
    print(f"[scale] EM iterations {res.em_iterations}; mapped reads {res.num_mapped}; "
          f"sketch_overflow {res.stats['sketch_overflow']}; expand_dropped {res.stats['expand_dropped']}; "
          f"candidate_spilled {res.stats['candidate_spilled']}; launches {launches}")
    require(launches["K1"] > 0 and launches["K4"] > 0, f"the main path skipped a kernel: {launches}")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * n_reads, f"only {res.num_mapped} reads mapped")

    # The first batch again, kernels against plain versions on the same tensors.
    L = 104  # round_up(100, 8): the width the quant path cut these reads to
    cap = config.sketch_capacity_for(31, L)
    c = torch.from_numpy(np.ascontiguousarray(codes[:BATCH, :L])).cuda()
    n = torch.from_numpy(lengths[:BATCH]).cuda()
    kw = dict(k=31, sketch_fraction=config.sketch_fraction, sketch_cap=cap,
              chain_fraction=config.chain_fraction, candidate_capacity=config.candidate_capacity,
              num_transcripts=index.num_transcripts)
    got = sketch_match_step(c, n, index.per_k[31], **kw)
    want = sketch_match_step(c, n, index.per_k[31], sketch=sketch_batch, sort=row_sort_plain, **kw)
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
    require(same, "first batch: kernel candidate tables differ from the plain functions'")
    print(f"[scale] first batch candidate tables: kernels == plain versions ({int(got.mask.sum())} candidates)")

    # Kernel times at the main path's shapes (this batch).
    h, m, _ = fused_sketch(c, n, 31, config.sketch_fraction, cap)
    start, length = probe(h, m, index.per_k[31].keys, index.per_k[31].row_ptr)
    key, _ = row_expand_from_runs(start, length, index.per_k[31].postings)
    k1 = time_pair_ms(torch, lambda: fused_sketch(c, n, 31, config.sketch_fraction, cap),
                      lambda: sketch_batch(c, n, 31, config.sketch_fraction, cap))
    k4 = time_pair_ms(torch, lambda: row_sort(key), lambda: row_sort_plain(key))
    print(f"[scale] main-path shapes: K1 [{BATCH}, {L}] cap {cap}: kernel {k1[0]:.4f} ms, plain {k1[1]:.4f} ms; "
          f"K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.4f} ms, plain {k4[1]:.4f} ms")
    for name, (ms, plain_ms) in (("K1", k1), ("K4", k4)):
        results[name].update(launches=launches[name], ms=round(ms, 5), plain_ms=round(plain_ms, 5))


def main() -> int:
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
    smi = phase_device(torch)
    phase_build()
    results = {
        "K1": {"name": "fused_sketch", "route": "cuda", "source": "sketch_rna_tpu_torch/csrc/sketch.cu",
               "replaces": "sketch_rna_tpu/hash/pallas_hash.py:160"},
        "K4": {"name": "row_sort", "route": "cuda", "source": "sketch_rna_tpu_torch/csrc/row_sort.cu",
               "replaces": "sketch_rna_tpu/match/pallas_sort.py:49"},
    }
    phase_kernels(torch, results)
    phase_sample()
    phase_scale(torch, results)
    print(json.dumps({"kernels": [results["K1"], results["K4"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
