#!/usr/bin/env python3
"""Drive the PyTorch port (sketch_rna_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py                    # from the repository root; needs one card
    python3 chip_smoke.py --phases kernels   # a subset (device and build always run)
    python3 chip_smoke.py --phases kernels --parent DIR   # + DIR's shared functions timed beside these,
                                                          # by this tree's utils/profiling.py on both sides
    python3 chip_smoke.py --phases shared-shapes         # only the shared functions' times, as JSON
    python3 chip_smoke.py --phases merge     # the merge kernel alone: its checks and times

Phases, in order; any failure raises and the script exits nonzero
without printing its result line:

  device        torch / CUDA versions, the card's name and power limit;
  build         nvcc builds the kernels in csrc/, one process per source;
  kernels       K1 (fused sketch), K2 (multi-k fused sketch), K3 (kept
                windows), K4 (row sort, int32), K4-int64 and E (posting
                expansion: [B, S] runs of up to 5,000 lanes a row, widths
                up to 131,072, empty rows and batches) against their
                plain PyTorch versions on the card, bit for bit, over the
                edges of their domains (K1 / K2 at 104, 152 and 1028
                bases, fractions 0.05 and 0.9999, caps that overflow; K3
                at [8192, 2048] and [8191, 2001] at an offset and one
                4-megabase index-build row, also at an odd offset,
                fractions 0.05 and 0.9999; K4 at every width 2 .. 16384
                and 8192, 8191 or 1 rows); then each kernel's device time
                at its main-path shape beside its plain version's,
                torch.sort's for K4, and its bound, and K4 against
                torch.sort at every width; then the functions both trees
                share (K3's call, sketch_reads of 2 kb and 20 kb reads,
                row_sort_wide, the merge at its four main-path shapes, P
                on the first c3 batch, S on the c3 EM's lanes: its tables'
                width tiers, joined), with
                --parent also in DIR.  Device time is torch.profiler's, per
                kernel launch or per whole call, over 50 calls whose inputs
                rotate through copies past the L2 cache (and outputs
                through as many buffers, each held until its turn comes
                round, so no output stays in the L2), timed in turns
                plain, kernel, kernel, plain; the host is left out;
  group         G (the grouping kernel: sort, run counts, chain test,
                top-C and the per-k intersection in one launch) against
                its plain version, the chain of K4 sorts and PyTorch
                operations (group_event_parts_plain), bit for bit: tables,
                candidate_spilled and candidate_spilled_per_k, at every
                row width 2 .. 1024 at one k and at two or three ks, C 8
                and 64, chain fractions 0.9 (the int32 test) and 1/sqrt(2)
                (the float32 one), 250,000 and 2^28 transcripts (past the
                int32 (rank, tid) packing), 2,047 rows and 1, edge rows
                (no event, one event, one tid in every lane, ties, every
                lane its own tid, an empty k); G's times on the first
                GENCODE batch's rows are the gencode phase's;
  merge         the merge kernel against bitonic_merge_pair, bit for bit,
                at every row width 2 .. 65536, int32 and int64, one row,
                B rows and B - 1 from an odd address, over random rows,
                runs of {0, 1, 2}, the type's extremes, all-equal rows,
                runs wholly below and wholly above each other and parts
                padded with the type's maximum; both routes (merge_pairs:
                the register merge up to 1024 lanes, merge_staged past
                that; merge_staged, the partition launch + the staged
                merge path, at every width); the partition launch
                against merge_partition_plain; the four main-path shapes
                ([8192, 256], [16384, 256], [8192, 512] int32 of the
                sharded route, [8192, 32768] int64 of row_sort_wide),
                row_sort_wide and an int32 sort_event_parts against
                torch.sort.  Then the device time per call over all its
                launches at the four shapes, beside the plain version,
                torch.sort and the bound, and each launch's time by name;
  probe-segsum  P (bucket probe) against its plain version and the
                searchsorted probe on the first c3 batch's sketches
                ([8192, 32] per k), [8191, 160] rows from an offset,
                [8192, 32] with every lane masked in and with none,
                [8191, 33] (no multiple of its block), an empty k, an
                index whose keys reach 0xFFFFFFFF, a table of mb 42 (the
                widest row one pass of P's loads covers) and one of mb
                1000 (a deep first bucket: P's loads take 23 passes); S (segmented sum)
                against its plain version on the c3 EM's lanes, 7 lanes
                fewer, one transcript over ~200 and ~1,100 blocks and the
                sample's EM lanes, at float64, float32 and int32, bit for
                bit and bit-stable between calls; then both timed (P per
                launch; S per call over 20 calls and
                launch by launch, on the c3 EM and the sample's, with the
                plan's build there) beside their yardstick calls: the
                searchsorted probe, index_add_;
  sample        the port's CLI on examples/sample.{fa,fq}, k=31: the CSV of
                a plain quant (default flags: float64 EM), of --em-dtype
                float64 and of --em-segsum on is byte-identical to
                examples/sample.expected.csv, the float32 CSV within 1e-4
                relative;
  sample-multik the CLI with -k 21,31, float64, on the card and in-process
                with --device cpu: same rows, values within 1e-9 relative;
  scale         6,000 synthetic isoform-family transcripts + 1,000,000
                reads of 100 bp, k=31, batch 8192, float32 EM;
  scale-multik  the c3_chr20_multik configuration: 20,000 transcripts
                (synth_transcriptome, seed 22) + 2,097,152 reads of 100 bp,
                k=(21, 31), batch 8192, float32 EM; then float64 with the
                default EM route and twice with --em-segsum on: the two
                bit-identical, within 1e-9 of the default, S launched
                once an iteration and twice in the assignment;
  crosscheck    the card's main path against formulations it shares no
                code with past the probe: every batch of scale (123) and
                of the c3 stand-in (256), as the fused engine forms them,
                through the row matcher (K1 / K2, P, K4) and through the
                global-sort matcher (match/candidates.py, plain PyTorch)
                on the same kernel-made sketches: equal tables, no event
                dropped; ORACLE_PROBLEM (2,000 transcripts, 8,192 reads,
                k = (21, 31), float64 EM) on the card against the
                reference math in NumPy (oracle/): collect_pairs equals
                oracle_sparse_chain, quantify's CSV rows oracle_quant's,
                values within 5e-9 relative; the roofline lines of scale
                and scale-multik (run here if those phases did not); and
                every problem's graph path (match_rows' default,
                pipeline.match_scan: one host read a length group, the
                batch steps replayed from CUDA graphs) equal to its eager
                per-batch path, tables and stats, with the graphs it
                captured and its peak device memory; then four more
                graph-path calls on the same index (two repeats, one
                under another chain fraction, one more under the first
                config), each equal to its config's eager path, the
                repeats capturing nothing (the graphs live with the
                index);
  fuzz          the oracle fuzz's trials 777000 .. 777047 on the card
                (oracle/fuzz.py, as scripts/fuzz_oracle_torch.py runs
                them), trial i in regime i mod 8 (fused one k, fused 2-3
                ks, streamed with tiny class buffers, sharded at mesh
                (1, 1), 1.1-2 kb reads, --em-segsum on, nine ks, 20 kb
                reads at sketch fraction 0.9), every other knob from the
                seed: collect_pairs == oracle_sparse_chain, pi and NumReads
                within 5e-9 of oracle_quant, equal CSV rows; at most a
                tenth skipped for a capacity stat; every kernel of
                counters(), the merge's partition launch included, launched
                in the phase; then a full batch of 8,192 reads holding one
                read past 16,384 events: that read sorts in a row slice of
                its own, the tables equal the plain functions', and the
                peak device memory with it and without it are printed;
  spill         300 transcripts sharing an 80-base core, ks (15, 31),
                C=8: per-k tables spill and the batch regroups merged
                (sort_event_parts: K4 + the merge kernel), equal to a
                forced merged run;
  long-reads    2,000 synthetic transcripts (families of 3-8 kb) + 100,000
                reads of 2,000 bp from those that hold one, k=31: reads past
                1024 windows sketch through K3 + K4-int64 alone, the dedup
                sorting at most 256 lanes; then 2,000 reads of 20,000 bp
                (nk_pad 32768) at k=31, whose kept hashes (~1,000 a read)
                sort on K4-int64 without a merge;
  stream        the scale-multik index and reads at float64 EM: the
                streamed engine (default knobs; a 2^16-row class buffer that
                compacts and drains; one full-width buffer) equals the fused
                run within 1e-9 relative;
  sharded       the multi-GPU route on the scale-multik index and reads at
                float64 EM: mesh (1, 1) in this process, then rank processes
                (this script's --rank-worker entry, one per rank, on the
                card(s) present: with fewer cards than ranks they share
                cuda:0 and the collectives travel over gloo through host
                memory, which a printed line states) at meshes (1, 2),
                (2, 1) and (2, 2).  Every rank's result equals the fused
                run within 1e-9 relative, with equal CSV rows, iterations
                and zero loss stats, and every rank returns rank 0's
                numbers; per mesh: reads/s, per-rank peak device memory
                and index bytes (about half at ip = 2), launches per batch
                of K2, K4, K4-int64 and the merge kernel, and the merge's
                device time at the gathered shapes beside its bound and
                torch.sort's of the same rows.  Then
                the CLI as two rank processes with --coordinator on
                examples/sample.fq, each parsing its byte range: rank 0's
                CSV is byte-identical to examples/sample.expected.csv and
                one process alone writes.  A rank that fails or hangs fails
                the phase (joined with a timeout, stragglers killed);
  stream-c3     BASELINE config 3 at its published size: 10,000,000 x 100 bp
                reads against the 20,000-transcript stand-in, k=(21, 31),
                streamed from 2-bit chunks made chunk by chunk, float32 EM,
                then once more at float64 EM (the default): em_assign
                seconds at both;
  cli-stream    the CLI's quant on a 2,200,000-read FASTQ: past the fused
                bound it must take the streamed route over the native scan
                feed (the Python feed, said so, if the native parser cannot
                build); the CSV equals in-process quantify_streamed;
  gencode       GENCODE width (bench.py's c4_gencode_* entries): the
                indexes of synth_transcriptome(default_rng(2026), 250,000)
                (298.5 Mbases) at k = 31 and at ks (21, 31), built on the
                card, each k equal to the JAX package's build (its keys,
                postings and sha256, GENCODE_INDEX); build seconds, peak
                device memory, index bytes, bucket tables and their deepest
                bucket; then 2^20 reads of 150 bp (seed 7, padded to 256) at
                float64 EM, fused at k = 31 and at ks (21, 31): timed after a
                warm-up with the roofline line, no lost work, every batch
                equal to the global-sort matcher and the graph path equal
                to the eager per-batch path (the graphs captured a quant,
                the batches G grouped and its peak memory printed), the
                streamed engine within 1e-9 relative, at k = 31
                --em-segsum on within 1e-9; the first batch of each
                through the kernels and the plain functions (equal tables),
                K1 (k = 31) and K2 (ks 21, 31) timed there at [8192, 152],
                E on the k = 31 batch's posting runs (its bound from that
                batch's events), and G on each batch's event rows against
                the plain grouping chain; 200 k = 31 quants on one index whose
                reserved device memory grows by under 64 MiB after the
                first two, with no graph captured after them;
                then 8,388,608 reads (~2.7 GB) from a FASTQ through the CLI
                (the streamed route over the native scan on a background
                thread: "native-lazy", the route of a file past 2 GiB), its
                CSV equal to an in-process quantify_streamed of the same
                codes;
                K1, K2, K3, K4, K4-int64, P and E each launched in the
                phase;
  graph-store   the match stage's graph store past its bound
                (utils/step_graphs.MAX_GRAPHS) on the GENCODE k = 31
                index (gencode's, or built as it builds it): the
                long-read cell's lengths (GRAPH_STORE_READS whole
                transcripts cut to 500-2,560 bases: length groups to pad
                2,560, the two longest through K3 and an eager phase 1)
                under GRAPH_STORE_CHAINS chain fractions in turn, for
                GRAPH_STORE_ROUNDS rounds: each call's tables and stats
                equal to its config's eager per-batch path, the first
                round capturing more keys than the store keeps and
                evicting, and the card's reserved memory after the last
                round under RESERVED_GROWTH_MIB above its level after
                the second;
  stages        the first per-stage device profile at GENCODE width,
                through the profile scripts' functions
                (scripts/profile_*_torch.py) on gencode's transcriptome,
                indexes and reads (built as gencode builds them when that
                phase did not run): every stage of sketch_match_step on
                the first [8192, 152] batch at k = 31 and ks (21, 31),
                the chained stages equal to the whole step and the
                kernel route equal to the plain route (sketch_all_k,
                row_sort_plain, probe_index_plain); one EM iteration, its
                E- and M-step and the assignment at each quant's class
                tables (their width tiers); t(21) + t(31) against t(21, 31)
                per stage and the merged grouping's sort both ways
                (bit-equal); the posterior-sum strategies over the k = 31
                EM tables' tiers and, in the same run, over those classes
                padded back into one [M, W] table (each within 1e-12 of
                index_add_, S bit-stable and equal to segsum_plain; the
                tiers hold fewer lanes, the same nonzero ones); each
                table's rows and width, the lanes and the zero lanes;
                the host feed of a 2,097,152-read FASTQ;
                then one fused 2^20-read float64 quant at k = 31 under
                torch.profiler: untraced and traced wall time, the
                card's busy and idle share, the 15 largest operations'
                device ms, launches and host operations per batch (K1,
                K4, P and E launched); match_scan per batch at k = 31
                and (21, 31) (profile_step_torch's scan row: wall and
                device ms, host operations, graphs a call, the
                synchronizing calls); the traced quant's match stage
                alone: at most one synchronize a length group plus one
                (its stats) and at most 9.86 torch operations a batch, a
                tenth of the per-batch route's 98.6 (PERF.md); the same
                trace of a two-group input (half the reads 300 bases):
                two groups, at most three synchronizes, and in both no
                host-to-device copy from pageable memory; a group's
                upload issued behind ~0.1 s of queued device work returns
                in under half of it (pinned; a pageable copy of the
                same rows beside it); one
                "[stages] {json}" line with the card's name and power
                limit;
  samples       examples/sample.{fa,fq}: refbin and npz indexes, a
                two-sample quant with --tpm (TPM = numpy recompute), and an
                EM checkpoint stopped after 2 iterations and resumed, equal
                to the one-shot run byte for byte.

With --profile, one steady streamed quant of the scale-multik reads runs
under torch.profiler last: device busy / idle share and time by item.

A scale phase builds its index on the card, runs one warm-up and one
timed quant (reads/s, stage seconds), counts kernel launches over the
timed quant (every count set to 0 just before it: P and E must launch
once a k and batch on scale and scale-multik, P on long-reads and
stream-c3 and never on the sharded route; a replayed CUDA graph adds
the launches its capture recorded), checks read-count conservation and
zero dropped
work, prints the timed run's roofline (utils/roofline.py, from its
QuantResult.sizes and stage times; every share of peak at most 1.0) and
holds the first batch's candidate tables against the plain functions on
the same tensors.

Then one JSON line per kernel ({"kernels": [...]}: launches on the main
path, device ms, plain ms, bound in ms and us with the bytes and
operations behind it, share of bound, library_ms (torch.sort for K4 and
the merge, the searchsorted probe for P, index_add_ for S; none for K1,
K2, K3 and E), the shared
functions' ms and, with --parent, the parent's),
the nvidia-smi line of the card, and last {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The timing helpers' file, when the tree under test runs this script in a
# parent checkout (parent_times): both trees are then timed by one copy.
TIMING_ENV = "CHIP_SMOKE_TIMING"


def timing_helpers():
    """utils/profiling.py: the file TIMING_ENV names, loaded by its path
    (a parent checkout may predate it or hold another copy), else this
    checkout's."""
    path = os.environ.get(TIMING_ENV)
    if not path:
        from sketch_rna_tpu_torch.utils import profiling

        return profiling
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_timing = timing_helpers()
REPS, busy_share, counters, cuda_events, device_ms, launch_split_ms, read_launches, reset_launches = (
    getattr(_timing, name) for name in ("REPS", "busy_share", "counters", "cuda_events", "device_ms",
                                        "launch_split_ms", "read_launches", "reset_launches"))
DEVICE = "cuda"
SEED = 1234
BATCH = 8192
# (transcripts, reads) of the scale phases
SCALE = (6000, 1_000_000)
SCALE_MULTIK = (20000, 1 << 21)
LONG_READS = (2000, 100_000)
VERY_LONG = (200, 2000, 20000)  # (transcripts, reads, read length)
ORACLE_PROBLEM = (2000, 8192)  # (transcripts, reads): bench.py's transcript count
# The fuzz phase: seeds FUZZ_BASE .. FUZZ_BASE + FUZZ_TRIALS - 1 of
# oracle/fuzz.py (scripts/fuzz_oracle_torch.py's default base), trial i
# in regime i mod 8.
FUZZ_BASE, FUZZ_TRIALS = 777000, 48
C3_READS = 10_000_000
CLI_READS = 2_200_000
# The gencode phase: bench.py's c4_gencode_* entries (bench.py:395-503):
# utils/synth.py gencode_transcriptome (250,000 transcripts, 298.5
# Mbases), GENCODE_READS reads of 150 bp (seed 7, padded to 256); the
# file-to-CSV step cut from the JAX script's 32M reads to
# GENCODE_FILE_READS (~2.7 GB, so the CLI takes its big-file route,
# "native-lazy").
GENCODE_READS = 1 << 20
GENCODE_FILE_READS = 8_388_608
RESERVED_CALLS = 200  # gencode: quants on one index whose reserved memory may grow
RESERVED_GROWTH_MIB = 64  # by less than this after the first two
STAGES_FEED_READS = 2_097_152  # the stages phase's FASTQ for the feed's rates
# The graph-store phase: reads, chain fractions run in turn, and rounds of them.
GRAPH_STORE_READS = 1 << 16
GRAPH_STORE_CHAINS = (0.9, 0.8, 0.7)
GRAPH_STORE_ROUNDS = 4
# The group phase: G against the plain chain at every row width 2 .. 1024,
# at one k and at two or three ks, on GROUP_ROWS rows (a ragged last
# block), each case at both candidate capacities, both chain tests (the
# int32 one at 9 / 10, the float32 one at a fraction with no small p / q)
# and both transcript counts (the second past the int32 (rank, tid)
# packing of the plain chain's top-C sort).
GROUP_ROWS = 2047
GROUP_WIDTHS = tuple((1 << e,) for e in range(1, 11)) + (
    (2, 1024), (128, 256), (256, 128), (256, 256), (512, 64), (1024, 1024), (64, 128, 256), (1024, 2, 16),
    (32, 32, 32))
GROUP_CAPACITIES = (8, 64)
GROUP_FRACTIONS = (0.9, 0.5 ** 0.5)
GROUP_TRANSCRIPTS = (250_000, 1 << 28)
STEP_EM = ("iteration", "e_step", "m_step", "assign")  # profile_step_torch.profile_em's measurements
L2_BYTES = 50 * 2**20
PHASES = ("kernels", "group", "merge", "probe-segsum", "sample", "sample-multik", "scale", "scale-multik", "crosscheck",
          "fuzz", "spill", "long-reads", "stream", "sharded", "stream-c3", "cli-stream", "gencode", "graph-store", "stages",
          "samples")
# The sharded phase's rank processes: (world size, meshes run in that world).
SHARDED_WORLDS = ((2, ((1, 2), (2, 1))), (4, ((2, 2),)))
RANK_JOIN_S = 420  # a world of rank processes is killed after this long
# The merge kernel's main-path shapes: (rows, row width, key type, where).
MERGE_SHAPES = ((BATCH, 256, "int32", "the sharded route's round, ip = 1"),
                (2 * BATCH, 256, "int32", "the sharded route's first round, ip = 2"),
                (BATCH, 512, "int32", "the sharded route's second round, ip = 2"),
                (BATCH, 1 << 15, "int64", "row_sort_wide's round"))
KERNELS = {
    "K1": ("fused_sketch", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:160"),
    "K2": ("fused_sketch_multik", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:266"),
    "K3": ("nthash_sketch", "sketch_rna_tpu_torch/csrc/hash.cu", "sketch_rna_tpu/hash/pallas_hash.py:46"),
    "K4": ("row_sort", "sketch_rna_tpu_torch/csrc/row_sort.cu", "sketch_rna_tpu/match/pallas_sort.py:49"),
    "K4-int64": ("row_sort (int64 keys)", "sketch_rna_tpu_torch/csrc/row_sort.cu",
                 "sketch_rna_tpu/match/pallas_sort.py:49"),
    # No TPU kernel merges: the JAX package's bitonic merge of sorted parts runs in XLA.
    "merge": ("merge_pairs", "sketch_rna_tpu_torch/csrc/merge.cu", "sketch_rna_tpu/match/rowmatch.py:122"),
    # Neither has a TPU kernel: the JAX package probes its bucket table and
    # sums segments in XLA.
    "P": ("bucket_lookup", "sketch_rna_tpu_torch/csrc/bucket_probe.cu", "sketch_rna_tpu/match/bucket_lookup.py:135"),
    "S": ("segsum_apply", "sketch_rna_tpu_torch/csrc/segsum.cu", "sketch_rna_tpu/em/segsum.py:114"),
    # No TPU kernel expands: the JAX package's static-shaped expansion runs in XLA.
    "E": ("row_expand", "sketch_rna_tpu_torch/csrc/expand.cu", "sketch_rna_tpu/match/rowmatch.py:74"),
    # No TPU kernel groups: the JAX package's run counting, top-C and per-k
    # intersection run in XLA.
    "G": ("group_rows", "sketch_rna_tpu_torch/csrc/group.cu", "sketch_rna_tpu/match/rowmatch.py:338"),
}


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rotation(args, nbytes: int):
    """Copies of the argument tuple, enough that cycling through them
    reads 2 x L2 from device memory (at most 64): a timed call finds its
    inputs cold, as the main path's kernels mostly do."""
    n = min(64, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def in_turns(torch, kernel_fn, plain_fn, arg_sets, kernel, reps=None):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = device_ms(plain_fn, arg_sets, reps=reps)
    k1 = device_ms(kernel_fn, arg_sets, kernel, reps)
    k2 = device_ms(kernel_fn, arg_sets, kernel, reps)
    p2 = device_ms(plain_fn, arg_sets, reps=reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def _keys(torch, gen, B, W, dtype):
    """[B, W] keys over the type's whole range, made on the card from gen:
    a quarter of the rows from {0, 1, 2} (long runs of equal keys) and 16
    rows of alternating extremes."""
    if dtype == torch.int32:
        x = torch.randint(-(2**31), 2**31, (B, W), generator=gen, device=DEVICE, dtype=torch.int64).to(dtype)
    else:
        hi = torch.randint(0, 2**32, (B, W), generator=gen, device=DEVICE, dtype=torch.int64)
        x = (hi << 32) | torch.randint(0, 2**32, (B, W), generator=gen, device=DEVICE, dtype=torch.int64)
        del hi
    q = B // 4
    x[:q] = torch.randint(0, 3, (q, W), generator=gen, device=DEVICE, dtype=torch.int64).to(dtype)
    x[q : q + 16, ::2] = torch.iinfo(dtype).min
    x[q : q + 16, 1::2] = torch.iinfo(dtype).max
    return x


def main_shape_cases(torch):
    """Each kernel at its main-path shape, inputs made from SEED: name ->
    (kernel callable, plain callable, kernel-name substring or None for
    the whole call, argument copies, (bytes, operations), shape).  K1 and
    K4 run on the single-k path, K2, K4 and K4-int64 on the multi-k one
    (PERF.md §6), K3 on long reads (the merge: phase_merge)."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_kept, sketch_all_k, sketch_batch
    from sketch_rna_tpu_torch.utils.roofline import kept_work, sketch_work, sort_work

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = QuantConfig()
    f = cfg.sketch_fraction
    L, ks = 104, (21, 31)
    cap = cfg.sketch_capacity_for(31, L)
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    reads = _read_batch(torch, rng, BATCH, L, 31)
    long_reads = _read_batch(torch, rng, BATCH, 2000, 31)
    m = nthash_sketch(*long_reads, 31, f)[0].shape[1]  # the kept pairs' width at these inputs
    cases = {
        "K1": (lambda c, n: fused_sketch(c, n, 31, f, cap), lambda c, n: sketch_batch(c, n, 31, f, cap),
               "sketch", reads, sketch_work(BATCH, L, (31,), (cap,)), f"[{BATCH}, {L}] k=31 cap {cap}"),
        "K2": (lambda c, n: fused_sketch_multik(c, n, ks, f, caps), lambda c, n: sketch_all_k(c, n, ks, f, caps),
               "sketch", reads, sketch_work(BATCH, L, ks, caps), f"[{BATCH}, {L}] ks {ks} caps {caps}"),
        "K3": (lambda c, n: nthash_sketch(c, n, 31, f), lambda c, n: hash_kept(c, n, 31, f), None, long_reads,
               kept_work(BATCH, 2000, 31, m), f"[{BATCH}, 2000] k=31 -> [{BATCH}, {m}] kept pairs"),
    }
    for name, dtype in (("K4", torch.int32), ("K4-int64", torch.int64)):
        x = _keys(torch, gen, BATCH, 256, dtype)
        cases[name] = (row_sort, row_sort_plain, "row_sort_kernel", (x,),
                       sort_work(BATCH, 256, x.element_size()), f"[{BATCH}, 256] {str(dtype)[6:]}")
    return {name: (fn, plain, kern, rotation(args, sum(a.numel() * a.element_size() for a in args)), work, shape)
            for name, (fn, plain, kern, args, work, shape) in cases.items()}


def shared_cases(torch, ctx):
    """Functions that take one signature in this tree and in its parent, at
    the long-read shapes, inputs made from SEED, and P and S at their
    main-path shapes on the c3 stand-in: name -> (callable, argument
    copies, calls per trace).  Each is timed per whole call."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.em.segsum import plan_from_tables, segsum_apply
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.match.bucket_lookup import bucket_lookup
    from sketch_rna_tpu_torch.match.row_sort import merge_pairs, row_sort_wide
    from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads

    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    cfg = QuantConfig()
    f = cfg.sketch_fraction
    cases = {}
    for B, L in ((BATCH, 2000), (2000, 20000)):
        reads = rotation(_read_batch(torch, rng, B, L, 31), B * L + 4 * B)
        cap = cfg.sketch_capacity_for(31, L)
        if L == 2000:
            cases[f"K3 [{B}, {L}] k=31"] = (lambda c, n: nthash_sketch(c, n, 31, f), reads, REPS)
        cases[f"sketch_reads [{B}, {L}] k=31"] = (lambda c, n, cap=cap: sketch_reads(c, n, (31,), f, (cap,)), reads,
                                                 REPS if L == 2000 else 5)
    x = _keys(torch, gen, BATCH, 1 << 15, torch.int64)
    cases[f"row_sort_wide [{BATCH}, {1 << 15}] int64"] = (row_sort_wide, [(x,)], 5)
    for B, W, dtype_name, _ in MERGE_SHAPES:  # per call, whatever launches either tree makes
        x = _halves(torch, _keys(torch, gen, B, W, getattr(torch, dtype_name)), W // 2)
        nbytes = 2 * x.numel() * x.element_size()
        cases[f"merge [{B}, {W}] {dtype_name}"] = (merge_pairs, rotation((x,), nbytes // 2),
                                                   REPS if nbytes < 2**28 else 10)
    t = c3_problem(torch, ctx)["index"].per_k[31].bucket
    h, m = c3_probe_batch(torch, ctx)[31]
    cases[f"bucket_lookup k=31 [{BATCH}, {h.shape[1]}]"] = (
        lambda h, m: bucket_lookup(h, m, t.packed, shift=t.shift, mb=t.mb), rotation((h, m), 9 * h.numel()), REPS)
    tables = c3_em_tables(torch, ctx)
    plan = plan_from_tables(tables, c3_problem(torch, ctx)["index"].num_transcripts)
    v = torch.rand(sum(t[0].numel() for t in tables), generator=gen, device=DEVICE, dtype=torch.float64)
    cases[f"segsum_apply c3 EM lanes [{v.numel()}] float64"] = (lambda v: segsum_apply(plan, v),
                                                                rotation((v,), 8 * v.numel()), 20)
    return cases


def shared_times(torch, ctx):
    """shared_cases' device ms per whole call, two traces each: what the
    shared-shapes phase prints for a comparison run."""
    return {name: (device_ms(fn, args, reps=reps) + device_ms(fn, args, reps=reps)) / 2
            for name, (fn, args, reps) in shared_cases(torch, ctx).items()}


def parent_times(torch, parent: Path):
    """shared_times of `parent`, a checkout of another commit holding this
    script, in a process of its own on this card, timed by this tree's
    utils/profiling.py (TIMING_ENV), as this tree's times are."""
    torch.cuda.empty_cache()
    env = dict(os.environ, **{TIMING_ENV: str(ROOT / "sketch_rna_tpu_torch" / "utils" / "profiling.py")})
    run = subprocess.run([sys.executable, str(parent / "chip_smoke.py"), "--phases", "shared-shapes"], cwd=parent,
                         env=env, capture_output=True, text=True, timeout=600)
    require(run.returncode == 0, f"the functions of {parent} did not run: {run.stdout[-1500:]}{run.stderr[-1500:]}")
    line = [ln for ln in run.stdout.splitlines() if ln.startswith('{"shared_ms"')]
    require(bool(line), f"no timing line from {parent}")
    return json.loads(line[-1])["shared_ms"]


def _odd_offset(torch, x):
    """A copy of x ([B, W]) whose first element sits one element past a
    16-byte boundary, so no row of it is aligned to 16 bytes as allocated."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _halves(torch, x, w):
    """x ([B, 2w]) with each row's two w-lane halves sorted by torch.sort:
    merge_pairs' input."""
    return torch.sort(x.view(-1, w), dim=1).values.view(x.shape[0], 2 * w)


def phase_kernels(torch, results, ctx, parent=None):
    """Every kernel against its plain version, bit for bit, at the edges
    of its domain; then device times (the host left out) at the main-path
    shapes and, for K4, at every width beside torch.sort; then the
    functions both trees share, with --parent also in the parent."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik, window_pad
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_kept, sketch_all_k, sketch_batch
    from sketch_rna_tpu_torch.utils.roofline import bound, sort_work

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = QuantConfig()
    # K1 and K2: fraction 0.05 (the default) and 0.9999, where nearly every
    # window is kept and a read's survivors overflow one warp (the wide
    # path); caps from the quant path's rule, 4 (overflow) and nk_pad
    # (room for every window); B - 1 rows from an offset of L bytes.
    ks = (21, 31)
    for L in (104, 152, 1028):
        codes, lengths = _read_batch(torch, rng, BATCH, L, 31)
        for f in (cfg.sketch_fraction, 0.9999):
            for c, n in ((codes, lengths), (codes[1:], lengths[1:])):
                for k in ks:
                    for cap in sorted({cfg.sketch_capacity_for(k, L), 4, window_pad(L, k)}):
                        if c is not codes and cap != 4:
                            continue
                        got = fused_sketch(c, n, k, f, cap)
                        want = sketch_batch(c, n, k, f, cap)
                        torch.cuda.synchronize()
                        require(same_tensors(torch, got, want),
                                f"K1 differs from sketch_batch at B={c.shape[0]} L={L} k={k} f={f} cap={cap}")
                        record(results, "K1", max_abs_err=max_err(got, want))
                        if cap == 4:
                            require(int(got[2]) > 0, f"cap 4 did not overflow at L={L} k={k} f={f}")
                        if f > 0.5 and cap == window_pad(L, k):
                            widest = int(got[1].sum(dim=1).max())
                            require(widest > 32, f"no read kept more than 32 hashes at L={L} k={k}")
                for caps in {tuple(cfg.sketch_capacity_for(k, L) for k in ks), (4, 4)}:
                    got = fused_sketch_multik(c, n, ks, f, caps)
                    want = sketch_all_k(c, n, ks, f, caps)
                    torch.cuda.synchronize()
                    for g, w, k in zip(got, want, ks):
                        require(same_tensors(torch, g, w),
                                f"K2 differs from sketch_batch at B={c.shape[0]} L={L} k={k} f={f} caps={caps}")
                        record(results, "K2", max_abs_err=max_err(g, w))
                    if caps == (4, 4):
                        require(min(int(g[2]) for g in got) > 0, f"K2 caps (4, 4) did not overflow at L={L} f={f}")
            print(f"[kernels] K1, K2 [{BATCH}, {L}] and [{BATCH - 1}, {L}] at an offset, fraction {f}: bit-equal")
        del codes, lengths
    # K3 against hash_kept, both output widths: a read batch; a ragged one
    # whose rows all start at odd addresses; one index-build chunk as a
    # row, aligned and at an odd address; fractions 0.05 and 0.9999.
    for f in (cfg.sketch_fraction, 0.9999):
        for B, L in ((BATCH, 2048), (BATCH - 1, 2002), (1, (1 << 22) + 30)):
            if B == 1:
                codes = torch.from_numpy(rng.integers(0, 4, size=(1, L)).astype(np.uint8)).to(DEVICE)
                lengths = torch.full((1,), L, dtype=torch.int32, device=DEVICE)
                views = ((codes, lengths), (_odd_offset(torch, codes), lengths))
            else:
                codes, lengths = _read_batch(torch, rng, B, L, 31)
                views = ((codes, lengths),) if L == 2048 else ((_odd_offset(torch, codes), lengths),)
            for c, n in views:
                for pow2 in (False, True):
                    got = nthash_sketch(c, n, 31, f, pow2)
                    want = hash_kept(c, n, 31, f, pow2)
                    torch.cuda.synchronize()
                    require(got[0].shape == want[0].shape and same_tensors(torch, got, want),
                            f"K3 differs from hash_kept at [{B}, {L}] f={f} pow2={pow2} address {c.data_ptr() % 16} "
                            "mod 16")
                    record(results, "K3", max_abs_err=max_err(got, want))
                print(f"[kernels] K3 [{B}, {L}] k=31 fraction {f}, rows from address {c.data_ptr() % 16} mod 16: "
                      f"bit-equal, {int(got[2].sum())} kept windows, width {want[0].shape[1]} (pow2)")
            del codes, lengths, views, c, n, got, want
    # Other ks: the first hash's k codes span one to seven 16-byte chunks.
    for k in (1, 15, 21, 33, 47, 64, 100):
        codes, lengths = _read_batch(torch, rng, 257, 3002, k)
        codes = _odd_offset(torch, codes)
        for f in (cfg.sketch_fraction, 0.9999):
            got, want = nthash_sketch(codes, lengths, k, f), hash_kept(codes, lengths, k, f)
            torch.cuda.synchronize()
            require(got[0].shape == want[0].shape and same_tensors(torch, got, want),
                    f"K3 differs from hash_kept at [257, 3002] k={k} f={f}")
        del codes, lengths, got, want
    print("[kernels] K3 [257, 3002] from an odd address, k in (1, 15, 21, 33, 47, 64, 100), fractions 0.05 and "
          "0.9999: bit-equal")
    # K4 at every width and three row counts (8191: a ragged last block;
    # the 8191 rows after the first, at an offset of W keys).
    for name, dtype in (("K4", torch.int32), ("K4-int64", torch.int64)):
        for W in (1 << e for e in range(1, 15)):
            x = _keys(torch, gen, BATCH, W, dtype)
            for rows in (x, x[1:], x[:1], x[: BATCH - 1].clone()):
                got = row_sort(rows)
                require(torch.equal(got, row_sort_plain(rows)), f"{name} differs from torch.sort at [{rows.shape[0]}, {W}]")
            record(results, name, max_abs_err=0)
            del x, rows, got
        print(f"[kernels] {name} [B, W], B in (8192, 8191, 8191 at an offset, 1), W = 2 .. 16384: bit-equal")
    _check_expand(torch, rng, results)

    # Device time per launch (torch.profiler; inputs cold in L2).
    print(f"[kernels] device ms per call, torch.profiler over {REPS} calls, plain / kernel / kernel / plain")
    for name, dtype in (("K4", torch.int32), ("K4-int64", torch.int64)):
        widths = {}
        for W in (1 << e for e in range(1, 15)):
            x = _keys(torch, gen, BATCH, W, dtype)
            nbytes, ops = sort_work(BATCH, W, x.element_size())
            reps = REPS if nbytes < 2**28 else 10
            ms, sort_ms = in_turns(torch, row_sort, row_sort_plain, rotation((x,), nbytes // 2), "row_sort_kernel",
                                   reps)
            b_ms, by = bound(nbytes, ops)
            widths[W] = {"ms": ms, "torch_sort_ms": sort_ms, "bound_ms": b_ms, "bound_by": by}
            print(f"[kernels] {name} [{BATCH}, {W}]: kernel {ms:.5f} ms, torch.sort {sort_ms:.5f} ms, bound "
                  f"{b_ms:.5f} ms ({by}), {100 * b_ms / ms:.1f}% of bound")
            del x
        record(results, name, by_width=widths)
    cases = main_shape_cases(torch)
    for name, (fn, plain, kern, arg_sets, (nbytes, ops), shape) in cases.items():
        reps = REPS if nbytes < 2**28 else 10
        ms, plain_ms = in_turns(torch, fn, plain, arg_sets, kern, reps)
        b_ms, by = bound(nbytes, ops)
        library_ms = None
        if name.startswith("K4"):
            library_ms = plain_ms
        timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
                     bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, library_ms=library_ms, shape=shape,
                     timed="per call" if kern is None else "per launch")
        record(results, name, **timed)
        print(f"[kernels] {name} {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              + (f"torch.sort {library_ms:.5f} ms, " if library_ms is not None else "")
              + f"bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes, {ops} operations), {100 * b_ms / ms:.1f}% of bound")
        if name == "K3":  # its two passes, per launch
            passes = {p: device_ms(fn, arg_sets, f"hash_kept_kernel<{w}>") for p, w in
                      (("count_pass_ms", "false"), ("write_pass_ms", "true"))}
            record(results, name, **passes)
            print(f"[kernels] K3 passes, device ms per launch: count {passes['count_pass_ms']:.5f}, "
                  f"write {passes['write_pass_ms']:.5f}")
    del cases

    # The functions both trees share, per whole call; with --parent, the
    # parent's before and after this tree's.
    p1 = parent_times(torch, parent) if parent else None
    mine = shared_times(torch, ctx)
    p2 = parent_times(torch, parent) if parent else None
    owners = {"row_sort_wide": "merge", "merge": "merge", "bucket_lookup": "P", "segsum_apply": "S"}
    for name, ms in mine.items():
        owner = results[owners.get(name.split()[0], "K3")]
        owner.setdefault("shared_ms", {})[name] = ms
        line = f"[kernels] {name}: device ms per call {ms:.5f}"
        if parent and name in p1 and name in p2:
            owner.setdefault("parent_shared_ms", {})[name] = (p1[name] + p2[name]) / 2
            line += f"; parent ({parent.name}) {p1[name]:.5f} / {p2[name]:.5f}"
        elif parent:
            line += f"; the parent ({parent.name}) does not time it"
        print(line)


def _group_case(torch, gen, B, widths, T):
    """Per-k [B, W_k] int32 event rows on the card, from gen, tids below T.
    A read draws its events at every k from one pool of 1 to 1,024 tids
    (t0 + j * stride mod T), j skewed toward the pool's first tids so the
    counts differ; a random number of its lanes hold events (all of them in
    a quarter of the rows), in random lanes among the sentinels.  Rows 0-6
    (where B > 6): no event at any k; one event; every lane one tid; 16
    tids tied (their order is the tid's); every lane its own tid (past 8
    candidates and past a k's table of min(16, W)); no event at the first
    k only (it passes vacuously); 8 tids at the top of the range."""
    I32_MAX = 2**31 - 1
    pools = torch.tensor([1, 2, 3, 5, 16, 64, 1024], device=DEVICE)
    m = pools[torch.randint(0, len(pools), (B,), generator=gen, device=DEVICE)]
    t0 = torch.randint(0, T, (B,), generator=gen, device=DEVICE)
    stride = torch.randint(1, max(T // 1024, 2), (B,), generator=gen, device=DEVICE)
    parts = []
    for ki, W in enumerate(widths):
        lane = torch.arange(W, device=DEVICE)
        u = torch.rand((B, W), generator=gen, device=DEVICE)
        tid = (t0[:, None] + (u * u * m[:, None]).long() * stride[:, None]) % T
        n_valid = torch.randint(0, W + 1, (B,), generator=gen, device=DEVICE)
        n_valid[torch.rand(B, generator=gen, device=DEVICE) < 0.25] = W
        key = torch.where(lane < n_valid[:, None], tid, I32_MAX)
        if B > 6:
            key[0] = I32_MAX
            key[1] = I32_MAX
            key[1, W - 1] = t0[1]
            key[2] = t0[2]
            key[3] = (t0[3] + lane % 16) % T
            key[4] = (t0[4] + lane) % T
            if ki == 0:
                key[5] = I32_MAX
            key[6] = T - 1 - lane % 8
        perm = torch.argsort(torch.rand((B, W), generator=gen, device=DEVICE), dim=1)
        parts.append(key.gather(1, perm).to(torch.int32))
    return parts


def _group_same(torch, got, want) -> bool:
    """Equal tables and both spill counts."""
    return (all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
            and all(int(got.stats[k]) == int(want.stats[k]) for k in ("candidate_spilled", "candidate_spilled_per_k")))


def phase_group(torch, results):
    """G (group_event_parts on the card) against its plain version
    (group_event_parts_plain: K4 sorts and PyTorch operations on the same
    card) bit for bit: tables, candidate_spilled and candidate_spilled_per_k,
    over every case of GROUP_WIDTHS x GROUP_TRANSCRIPTS x GROUP_CAPACITIES
    x GROUP_FRACTIONS on _group_case's rows, and on one row of each width
    set; one launch a call.  The cases must spill at C and per k, and the
    plain chain must take both of its top-C key types."""
    import collections

    from sketch_rna_tpu_torch.match.group import group_rows
    from sketch_rna_tpu_torch.match.rowmatch import group_event_parts, group_event_parts_plain

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    seen = collections.Counter()
    keys = collections.Counter()
    t0 = time.perf_counter()
    with _top_c_keys(keys):
        for widths in GROUP_WIDTHS:
            for T in GROUP_TRANSCRIPTS:
                for B in (GROUP_ROWS, 1):
                    parts = _group_case(torch, gen, B, widths, T)
                    for C in GROUP_CAPACITIES:
                        for fraction in GROUP_FRACTIONS:
                            kw = dict(chain_fraction=fraction, candidate_capacity=C, num_transcripts=T)
                            before = group_rows.launches
                            got = group_event_parts(parts, **kw)
                            want = group_event_parts_plain(parts, **kw)
                            torch.cuda.synchronize()
                            require(group_rows.launches == before + 1, f"G did not launch once at widths {widths}")
                            require(_group_same(torch, got, want),
                                    f"G differs from the plain chain at [{B}, {widths}] T={T} C={C} fraction "
                                    f"{fraction}: stats {({k: int(v) for k, v in got.stats.items()})} against "
                                    f"{({k: int(v) for k, v in want.stats.items()})}")
                            seen["cases"] += 1
                            seen["candidates"] += int(got.mask.sum())
                            seen["spilled"] += int(got.stats["candidate_spilled"]) > 0
                            seen["spilled_per_k"] += int(got.stats["candidate_spilled_per_k"]) > 0
            print(f"[group] widths {widths}: G == the plain chain over {len(GROUP_TRANSCRIPTS)} transcript counts, "
                  f"rows {GROUP_ROWS} and 1, C {GROUP_CAPACITIES}, chain fractions {GROUP_FRACTIONS}")
    require(seen["spilled"] > 0 and seen["spilled_per_k"] > 0, f"the group cases never spilled: {dict(seen)}")
    require(keys["int32"] > 0 and keys["int64"] > 0, f"the plain chain's top-C took key types {dict(keys)}")
    record(results, "G", max_abs_err=0)
    print(f"[group] {seen['cases']} cases bit-equal ({seen['candidates']} candidates; {seen['spilled']} cases spilled "
          f"at C, {seen['spilled_per_k']} per k; the plain chain's top-C keys {dict(keys)}) in "
          f"{time.perf_counter() - t0:.1f} s")


def _event_parts(torch, index, config, c, n, caps):
    """One batch's per-k event rows as the path makes them (the sketch
    kernels, P, E), each k at its width for the batch's most events."""
    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
    from sketch_rna_tpu_torch.match.expand import row_expand
    from sketch_rna_tpu_torch.match.rowmatch import expand_width
    from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads

    ks = tuple(index.kmer_lengths)
    parts = []
    for (h, m, _), k in zip(sketch_reads(c, n, ks, config.sketch_fraction, caps), ks):
        start, length = probe_index(h, m, index.per_k[k])
        parts.append(row_expand(start, length, index.per_k[k].postings, expand_width(int(length.sum(dim=1).max()))))
    return parts


def _time_group(torch, results, tag, index, config, c, n, caps):
    """G on a batch's event rows (_event_parts) at the widths the path gives
    them: equal to the plain chain, then timed per launch against that
    chain's whole call (in turns), with its bound (utils/roofline.py
    group_work); one k's times go to the kernel's entry, several ks' under
    "multik"."""
    from sketch_rna_tpu_torch.match.rowmatch import group_event_parts, group_event_parts_plain
    from sketch_rna_tpu_torch.utils.roofline import bound, group_work

    parts = _event_parts(torch, index, config, c, n, caps)
    kw = dict(chain_fraction=config.chain_fraction, candidate_capacity=config.candidate_capacity,
              num_transcripts=index.num_transcripts)
    got, want = group_event_parts(parts, **kw), group_event_parts_plain(parts, **kw)
    require(_group_same(torch, got, want), f"{tag}: G differs from the plain chain on the first batch's rows")
    nbytes, ops = group_work(c.shape[0], [p.shape[1] for p in parts], config.candidate_capacity)
    arg_sets = rotation(tuple(parts), sum(4 * p.numel() for p in parts))
    ms, plain_ms = in_turns(torch, lambda *p: group_event_parts(list(p), **kw),
                            lambda *p: group_event_parts_plain(list(p), **kw), arg_sets, "group_kernel")
    call_ms = device_ms(lambda *p: group_event_parts(list(p), **kw), arg_sets)
    b_ms, by = bound(nbytes, ops)
    shape = " + ".join(f"[{p.shape[0]}, {p.shape[1]}]" for p in parts) + f" k={','.join(map(str, index.kmer_lengths))}"
    timed = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
                 bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, library_ms=None, shape=shape,
                 timed="per launch", candidates=int(got.mask.sum()))
    if len(parts) == 1:
        record(results, "G", **timed)
    else:
        record(results, "G", multik=timed)
    print(f"[{tag}] G {shape} (the first batch's rows, {timed['candidates']} candidates): == the plain chain; kernel "
          f"{ms:.5f} ms a launch ({call_ms:.5f} ms a call), the plain chain {plain_ms:.5f} ms a call, bound "
          f"{b_ms * 1e3:.3f} us ({by}: {nbytes} bytes, {ops} operations), {100 * b_ms / ms:.1f}% of bound")


def _expand_runs(torch, rng, B, S, P):
    """[B, S] posting runs into postings [P], made from rng: run lengths
    0-6 with a quarter of the lanes masked out and a fifth of the rows
    empty, starts inside postings, on the card."""
    import numpy as np

    length = rng.integers(0, 7, size=(B, S)) * (rng.random((B, S)) < 0.75)
    length[rng.random(B) < 0.2] = 0
    start = rng.integers(0, P - 6, size=(B, S)) * (length > 0)
    return torch.from_numpy(start).to(DEVICE), torch.from_numpy(length).to(DEVICE)


def _check_expand(torch, rng, results):
    """E against row_expand_plain, bit for bit: [8192, 32] and [8191, 32]
    runs at their widest row's width and at 8x it, one lane, one row,
    rows past one tile of runs (3,000 and 5,000 runs a row, W up to
    131,072), rows of no run, a batch of empty runs at W = MIN_WIDTH, and
    runs from an offset."""
    import numpy as np

    from sketch_rna_tpu_torch.match.expand import row_expand, row_expand_plain
    from sketch_rna_tpu_torch.match.row_sort import MIN_WIDTH
    from sketch_rna_tpu_torch.match.rowmatch import expand_width

    P = 100_000
    post = torch.from_numpy(rng.integers(0, 10**6, size=P).astype(np.int32)).to(DEVICE)
    cases = 0
    for B, S in ((BATCH, 32), (BATCH - 1, 32), (1, 1), (64, 3000), (7, 5000), (100, 1), (5, 0)):
        start, length = _expand_runs(torch, rng, B, S, P)
        most = int(length.sum(dim=1).max()) if S else 0
        for W in sorted({expand_width(most), 8 * expand_width(most)}):
            for s, ln in ((start, length), (start[1:], length[1:])):
                got, want = row_expand(s, ln, post, W), row_expand_plain(s, ln, post, W)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"E differs from row_expand_plain at [{s.shape[0]}, {S}] W={W}")
                cases += 1
    z = torch.zeros((BATCH, 32), dtype=torch.int64, device=DEVICE)
    got = row_expand(z, z, post, MIN_WIDTH)
    require(torch.equal(got, row_expand_plain(z, z, post, MIN_WIDTH)) and bool((got == 2**31 - 1).all()),
            "E on a batch of empty runs")
    record(results, "E", max_abs_err=0)
    print(f"[kernels] E [B, S] -> [B, W]: {cases + 1} cases (S up to 5,000 runs a row, W up to 131,072, rows "
          "without events, a batch without any, an offset): bit-equal to row_expand_plain")


def _merge_rows(torch, gen, B, W, dtype):
    """[B, W] merge inputs (two ascending W/2-key runs a row) made on the
    card from gen: _keys' rows, and from B = 64 on, in four sixteenths of
    the rows past the middle: all-equal rows; runs with a wholly below b;
    a wholly above b; parts of a few small keys padded with the type's
    maximum, as the sharded route's event parts are."""
    x = _keys(torch, gen, B, W, dtype)
    w, n, s = W // 2, B // 16, B // 2
    if B >= 64:
        x[s : s + n] = 7
        lo = torch.randint(-(2**20), 0, (n, w), generator=gen, device=DEVICE, dtype=torch.int64).to(dtype)
        hi = torch.randint(0, 2**20, (n, w), generator=gen, device=DEVICE, dtype=torch.int64).to(dtype)
        x[s + n : s + 2 * n, :w], x[s + n : s + 2 * n, w:] = lo, hi
        x[s + 2 * n : s + 3 * n, :w], x[s + 2 * n : s + 3 * n, w:] = hi, lo
        del lo, hi
        keys = torch.randint(0, 64, (n, 2, w), generator=gen, device=DEVICE, dtype=torch.int64).to(dtype)
        count = torch.randint(0, w + 1, (n, 2, 1), generator=gen, device=DEVICE)
        lane = torch.arange(w, device=DEVICE)
        x[s + 3 * n : s + 4 * n] = torch.where(lane < count, keys, torch.iinfo(dtype).max).view(n, W)
        del keys
    return _halves(torch, x, w)


def phase_merge(torch, results):
    """The merge kernel against bitonic_merge_pair, bit for bit, on both
    routes; row_sort_wide and sort_event_parts against torch.sort; then
    device times per call (all launches) and per launch at the main-path
    shapes."""
    from sketch_rna_tpu_torch.match.row_sort import (REGISTER_MERGE_MAX_WIDTH, bitonic_merge_pair, merge_pairs,
                                                     merge_partition, merge_partition_plain, merge_staged,
                                                     merge_tile, row_sort_plain, row_sort_wide)
    from sketch_rna_tpu_torch.match.rowmatch import I32_MAX, sort_event_parts
    from sketch_rna_tpu_torch.utils.roofline import bound, merge_work

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)

    def plain(x):
        w = x.shape[1] // 2
        return bitonic_merge_pair(x[:, :w], x[:, w:])

    # Every row width 2 .. 65536 (one row, B rows, B - 1 rows from an odd
    # address; B shrinks past 8192 lanes): merge_pairs, and below its cut
    # also the staged route that it takes past the cut.
    for dtype in (torch.int32, torch.int64):
        tile = merge_tile(dtype)
        for W in (1 << e for e in range(1, 17)):
            B = BATCH if W <= 1 << 13 else (1 << 26) // W
            x = _merge_rows(torch, gen, B, W, dtype)
            for rows in (x, x[:1], _odd_offset(torch, x[1:])):
                want = plain(rows)
                for fn in (merge_pairs, merge_staged) if W <= REGISTER_MERGE_MAX_WIDTH else (merge_pairs,):
                    got = fn(rows)
                    require(torch.equal(got, want), f"{fn.__name__} differs from bitonic_merge_pair at "
                                                    f"[{rows.shape[0]}, {W}] {dtype}")
                for t in (tile, 7, 1) if W <= 4096 else (tile, 7):
                    require(torch.equal(merge_partition(rows, t), merge_partition_plain(rows, t)),
                            f"merge_partition differs from merge_partition_plain at [{rows.shape[0]}, {W}] {dtype} "
                            f"tile {t}")
            del x, rows, got, want
        print(f"[merge] {str(dtype)[6:]} [B, W], W = 2 .. 65536, one row, B rows and B - 1 from an odd address, "
              f"random, {{0, 1, 2}}, extremes, all-equal, disjoint both ways, sentinel-padded: the register merge "
              f"(up to {REGISTER_MERGE_MAX_WIDTH} lanes) and the staged path (every width) bit-equal to "
              f"bitonic_merge_pair; the "
              f"partition launch at tiles {tile}, 7 and 1 (W <= 4096) equal to merge_partition_plain")
    record(results, "merge", max_abs_err=0)
    for B, W, dtype_name, what in MERGE_SHAPES:
        x = _merge_rows(torch, gen, B, W, getattr(torch, dtype_name))
        require(torch.equal(merge_pairs(x), plain(x)),
                f"merge_pairs differs from bitonic_merge_pair at [{B}, {W}] {dtype_name} ({what})")
        del x
    print("[merge] the main-path shapes " + ", ".join(f"[{B}, {W}] {t}" for B, W, t, _ in MERGE_SHAPES)
          + ": bit-equal")
    for widths in ((512, 300), (256, 130, 256)):
        parts = [_keys(torch, gen, BATCH, w, torch.int32) for w in widths]
        span = (1 << (len(widths) - 1).bit_length()) * max(widths)
        fill = torch.full((BATCH, span - sum(widths)), I32_MAX, dtype=torch.int32, device=DEVICE)
        got = sort_event_parts(parts)
        require(torch.equal(got, row_sort_plain(torch.cat(parts + [fill], dim=1))),
                f"sort_event_parts differs from torch.sort at part widths {widths}")
        print(f"[merge] sort_event_parts int32 [{BATCH}] x part widths {widths} -> [{BATCH}, {span}]: "
              "equal to torch.sort")
    del parts, fill, got
    wide = {}
    for B, W in ((BATCH, 1 << 15), (1024, 1 << 16)):
        x = _keys(torch, gen, B, W, torch.int64)
        got, want = row_sort_wide(x), row_sort_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"row_sort_wide differs from torch.sort at [{B}, {W}]")
        del got, want
        ms, sort_ms = in_turns(torch, row_sort_wide, row_sort_plain, [(x,)], None, reps=5)
        wide[f"[{B}, {W}] int64"] = {"ms": ms, "torch_sort_ms": sort_ms}
        print(f"[merge] row_sort_wide int64 [{B}, {W}]: bit-equal; device ms per call: {ms:.4f} (K4-int64 chunks "
              f"+ {int(math.log2(W >> 14))} merges), torch.sort {sort_ms:.4f}")
        del x
    record(results, "merge", row_sort_wide=wide)

    # Device time per call, all launches (torch.profiler; inputs cold in L2).
    print(f"[merge] device ms per call (every launch of a call), torch.profiler over {REPS} calls (10 past 256 MB), "
          "plain / kernel / kernel / plain; then per launch, by kernel")
    shapes = {}
    for B, W, dtype_name, what in MERGE_SHAPES:
        x = _merge_rows(torch, gen, B, W, getattr(torch, dtype_name))
        nbytes, ops = merge_work(B, W, x.element_size())
        arg_sets = rotation((x,), nbytes // 2)
        reps = REPS if nbytes < 2**28 else 10
        ms, plain_ms = in_turns(torch, merge_pairs, plain, arg_sets, None, reps)
        split = launch_split_ms(merge_pairs, arg_sets, "merge_", reps)
        sort_ms = device_ms(row_sort_plain, arg_sets, reps=reps)
        b_ms, by = bound(nbytes, ops)
        shapes[f"[{B}, {W}] {dtype_name}"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=sort_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
            bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, what=what,
            launch_ms={name: t for name, (t, _) in split.items()})
        print(f"[merge] [{B}, {W}] {dtype_name} ({what}): kernel {ms * 1e3:.2f} us a call (launches "
              + ", ".join(f"{name} {t * 1e3:.2f} us, {n} traced in {reps} calls" for name, (t, n) in split.items())
              + f"), plain {plain_ms * 1e3:.2f} us, torch.sort {sort_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
              f"({by}: {nbytes} bytes, {ops} operations), {100 * b_ms / ms:.1f}% of bound")
        del x, arg_sets
    main = shapes[f"[{BATCH}, 256] int32"]
    record(results, "merge", **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                     "bound_us", "bound_share", "bound_bytes", "bound_ops")},
           shape=f"[{BATCH}, 256] int32 ({main['what']})", timed="per call (all launches)", shapes=shapes)


def c3_em_tables(torch, ctx):
    """The c3 stand-in's EM lanes: the tables the fused engine runs its EM
    over for the 2^21 reads (match_rows, then pipeline.em_tables as
    _quantify_fused calls it: the class tables' width tiers, singletons
    folded); built once."""
    if "c3_em" not in ctx:
        from sketch_rna_tpu_torch.match.rowmatch import pow2ceil
        from sketch_rna_tpu_torch.pipeline import em_tables, match_rows

        c3 = c3_problem(torch, ctx)
        cfg, T = c3["config"], c3["index"].num_transcripts
        tid, score, n_padded, _ = match_rows(c3["index"], torch.from_numpy(c3["codes"]), c3["lengths"], cfg)
        W = min(pow2ceil(max(int((score > 0).sum(dim=1).max()), 1)), cfg.candidate_capacity)
        ctx["c3_em"] = em_tables(tid[:, :W], score[:, :W], cfg, num_transcripts=T, n_rows=n_padded)[0]
        print("[c3] EM tables (rows x width): " + ", ".join(f"{t[0].shape[0]} x {t[0].shape[1]}" for t in ctx["c3_em"])
              + f"; {sum(t[0].numel() for t in ctx['c3_em'])} lanes, of a [{tid.shape[0]}, {W}] candidate table")
    return ctx["c3_em"]


def c3_probe_batch(torch, ctx):
    """The first c3 batch's sketches, k -> (hashes, mask) [8192, 32] (the
    fused path's width at 100 bp); built once."""
    if "c3_probe" not in ctx:
        import numpy as np

        from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads

        c3 = c3_problem(torch, ctx)
        cfg = c3["config"]
        ks = cfg.kmer_lengths
        c = torch.from_numpy(np.ascontiguousarray(c3["codes"][:BATCH, :104])).to(DEVICE)
        n = torch.from_numpy(c3["lengths"][:BATCH]).to(DEVICE)
        caps = tuple(cfg.sketch_capacity_for(k, 104) for k in ks)
        ctx["c3_probe"] = {k: (h.contiguous(), m.contiguous())
                           for (h, m, _), k in zip(sketch_reads(c, n, ks, cfg.sketch_fraction, caps), ks)}
    return ctx["c3_probe"]


def sample_em_lanes(torch):
    """The sample's EM lanes (examples/sample.{fa,fq}, k=31, 30
    transcripts): the candidate table the fused engine runs its EM over,
    unfolded (fewer than 1024 padded reads).  Returns (flat tids, T)."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import load_fasta
    from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
    from sketch_rna_tpu_torch.io.packing import pack_reads
    from sketch_rna_tpu_torch.match.rowmatch import pow2ceil
    from sketch_rna_tpu_torch.pipeline import match_rows

    cfg = QuantConfig()
    ex = ROOT / "examples"
    index = to_device(build_index(load_fasta(str(ex / "sample.fa")), cfg, device=DEVICE), DEVICE)
    reads = load_fastq_dict(str(ex / "sample.fq"), min_len=31)
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=31)
    tid, score, _, _ = match_rows(index, torch.from_numpy(packed.codes), packed.lengths, cfg)
    W = min(pow2ceil(max(int((score > 0).sum(dim=1).max()), 1)), cfg.candidate_capacity)
    return tid[:, :W].reshape(-1).contiguous(), index.num_transcripts


def phase_probe_segsum(torch, results, ctx):
    """P (bucket probe) and S (segmented sum) against their plain versions
    on the card, bit for bit, then timed at their main-path shapes beside
    the yardstick call: P against match/probe.py's searchsorted probe on
    the same hashes and index, S against one
    index_add_ of the same values, per call and launch by launch, on the
    c3 EM's lanes and on the sample's."""
    import numpy as np

    from sketch_rna_tpu_torch.em.segsum import build_segsum_plan, plan_from_tables, segsum_apply, segsum_plain
    from sketch_rna_tpu_torch.match.bucket_lookup import bucket_lookup, bucket_lookup_plain, device_bucket_table
    from sketch_rna_tpu_torch.match.probe import probe
    from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold
    from sketch_rna_tpu_torch.utils.roofline import bound, probe_work, segsum_work

    c3 = c3_problem(torch, ctx)
    index, cfg = c3["index"], c3["config"]
    f = cfg.sketch_fraction
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    print(f"[probe-segsum] P tables of the c3 index: " + ", ".join(
        f"k={k}: [{ki.bucket.packed.shape[0]}, {ki.bucket.packed.shape[1]}] (mb {ki.bucket.mb}, shift "
        f"{ki.bucket.shift}) {ki.bucket.nbytes} bytes" for k, ki in index.per_k.items()))

    def u32(x):
        return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64)).to(DEVICE)

    def table_of(keys_np, rng):
        """(table, keys, row_ptr) of sorted uint32 keys with random runs."""
        rp = np.concatenate([[0], np.cumsum(rng.integers(1, 6, keys_np.size))]).astype(np.int64)
        keys, row_ptr = u32(keys_np), torch.from_numpy(rp).to(DEVICE)
        return device_bucket_table(keys_np, keys, row_ptr), keys, row_ptr

    def rand_mask(shape, p):
        return torch.rand(shape, generator=gen, device=DEVICE) < p

    # name -> (hashes, mask, table, keys, row_ptr): the first c3 batch's
    # sketches per k ([8192, 32], the fused path's width at 100 bp); a
    # 2,000 bp read batch's width ([8191, 160] rows from an offset, 60% of
    # the lanes the index's keys); of those hashes, [8192, 32] with every
    # lane masked in and with none, and [8191, 33] (no multiple of P's
    # 256-lane block); an empty k; an index whose keys reach 0xFFFFFFFF
    # (fraction 0.9999 and the top key a fraction-1.0 index can hold),
    # probed with its keys, random words and 0xFFFFFFFF; a table of mb 42
    # (3 * mb <= 128, the widest row the builder's bucket merging makes,
    # which one pass of P's loads covers); a table of mb 1000, whose first
    # histogram the builder cannot merge (a dense cluster under a key of
    # 0xFFFFFFFF), so P's loads take several passes.
    cases = {}
    for k, (h, m) in c3_probe_batch(torch, ctx).items():
        ki = index.per_k[k]
        cases[f"k={k} [{BATCH}, {h.shape[1]}]"] = (h, m, ki.bucket, ki.keys, ki.row_ptr)
    ki = index.per_k[31]
    c31 = (ki.bucket, ki.keys, ki.row_ptr)
    S = cfg.sketch_capacity_for(31, 2000)
    pick = torch.randint(0, ki.keys.numel(), (BATCH, S), generator=gen, device=DEVICE)
    miss = torch.randint(0, fracminhash_threshold(f) + 1, (BATCH, S), generator=gen, device=DEVICE)
    h = torch.where(rand_mask((BATCH, S), 0.6), ki.keys[pick], miss)
    m = rand_mask((BATCH, S), 98.5 / S)
    cases[f"k=31 [{BATCH - 1}, {S}] at an offset"] = (h[1:], m[1:], *c31)
    cases[f"k=31 [{BATCH}, 32] every lane masked in"] = (h[:, :32], torch.ones_like(m[:, :32]), *c31)
    cases[f"k=31 [{BATCH}, 32] no lane masked in"] = (h[:, :32], torch.zeros_like(m[:, :32]), *c31)
    cases[f"k=31 [{BATCH - 1}, 33] at an offset"] = (h[1:, :33], m[1:, :33], *c31)
    empty = u32([])
    cases["empty k"] = (h, m, device_bucket_table(np.zeros(0, np.uint32), empty, torch.zeros(1, dtype=torch.int64,
                        device=DEVICE)), empty, torch.zeros(1, dtype=torch.int64, device=DEVICE))
    rng = np.random.default_rng(SEED + 12)
    top = np.unique(np.concatenate([rng.integers(0, fracminhash_threshold(0.9999), 1 << 20, dtype=np.uint64),
                                    [0xFFFFFFFF]]).astype(np.uint32))
    t, keys, row_ptr = table_of(top, rng)
    q = torch.where(rand_mask((BATCH, 32), 0.5),
                    keys[torch.randint(0, keys.numel(), (BATCH, 32), generator=gen, device=DEVICE)],
                    torch.randint(0, 1 << 32, (BATCH, 32), generator=gen, device=DEVICE))
    q[:, 0] = 0xFFFFFFFF
    cases["fraction 0.9999 + key 0xFFFFFFFF [8192, 32]"] = (q, rand_mask((BATCH, 32), 0.8), t, keys, row_ptr)
    # mb 42: ~2,000 random words over 1,024 buckets (shift 22) and 42 keys
    # in bucket 5, probed half with keys of that bucket.
    rand = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    wide = np.unique(np.concatenate([rand[(rand >> 22) != 5],
                                     (5 << 22) + rng.choice(1 << 22, 42, replace=False).astype(np.uint64)]))
    t, keys, row_ptr = table_of(wide.astype(np.uint32), rng)
    require(t.mb == 42, f"the one-pass table has mb {t.mb}, not 42")
    in5 = keys[(keys >> 22) == 5]
    q = torch.where(rand_mask((BATCH, 32), 0.5),
                    in5[torch.randint(0, in5.numel(), (BATCH, 32), generator=gen, device=DEVICE)],
                    torch.randint(0, 1 << 32, (BATCH, 32), generator=gen, device=DEVICE))
    cases[f"mb 42 [{BATCH}, 32]"] = (q, rand_mask((BATCH, 32), 0.9), t, keys, row_ptr)
    # mb 1000: 1,000 keys in [0, 2000] and 0xFFFFFFFF over 1,024 buckets
    # (shift 22), all but the last in bucket 0; probed a third with those
    # keys, a third with other words below 2001 (misses through the whole
    # deep row) and a third with random words, column 0 0xFFFFFFFF.
    deep = np.concatenate([np.sort(rng.choice(2001, 1000, replace=False)), [0xFFFFFFFF]]).astype(np.uint32)
    t, keys, row_ptr = table_of(deep, rng)
    require(t.mb == 1000 and t.shift == 22, f"the deep table has mb {t.mb}, shift {t.shift}, not 1000, 22")
    third = torch.randint(0, 3, (BATCH, 32), generator=gen, device=DEVICE)
    q = torch.where(third == 0, keys[torch.randint(0, keys.numel() - 1, (BATCH, 32), generator=gen, device=DEVICE)],
                    torch.where(third == 1, torch.randint(0, 2001, (BATCH, 32), generator=gen, device=DEVICE),
                                torch.randint(0, 1 << 32, (BATCH, 32), generator=gen, device=DEVICE)))
    q[:, 0] = 0xFFFFFFFF
    cases[f"mb 1000 [{BATCH}, 32]"] = (q, rand_mask((BATCH, 32), 0.9), t, keys, row_ptr)

    for name, (h, m, t, keys, row_ptr) in cases.items():
        want = bucket_lookup_plain(h, m, t.packed, shift=t.shift, mb=t.mb)
        runs = probe(h, m, keys, row_ptr)
        got = bucket_lookup(h, m, t.packed, shift=t.shift, mb=t.mb)
        torch.cuda.synchronize()
        require(same_tensors(torch, got, want), f"P differs from bucket_lookup_plain at {name}")
        require(same_tensors(torch, got, runs), f"P differs from the searchsorted probe at {name}")
        record(results, "P", max_abs_err=max_err(got, want))
        print(f"[probe-segsum] P {name} (mb {t.mb}): bit-equal to bucket_lookup_plain and to the searchsorted probe, "
              f"{int(m.sum())} lanes masked in, {int((got[1] > 0).sum())} hits")

    # S on the c3 EM's lanes, on a lane count that is no multiple of 512,
    # on one transcript spanning ~200 blocks and ~1,100 blocks (its carries
    # span three carry blocks of 512: the top scan runs), and on the
    # sample's EM lanes; float64, float32, int32.
    tables = c3_em_tables(torch, ctx)
    T = index.num_transcripts
    flat_tid = torch.cat([t[0].reshape(-1) for t in tables])
    n = flat_tid.numel()

    def one_long(blocks):
        spread = torch.randint(0, T, (50_000,), generator=gen, device=DEVICE, dtype=torch.int32)
        tids = torch.cat([torch.full((blocks * 512,), 17, dtype=torch.int32, device=DEVICE), spread])
        return tids[torch.randperm(tids.numel(), generator=gen, device=DEVICE)]

    sample_tid, sample_T = sample_em_lanes(torch)
    plans = {f"c3 EM lanes [{n}]": (plan_from_tables(tables, T), flat_tid, T),
             f"c3 EM lanes [{n - 7}]": (build_segsum_plan(flat_tid[: n - 7], T), flat_tid[: n - 7], T)}
    for blocks in (195, 1100):
        tids = one_long(blocks)
        plans[f"one transcript over {blocks}+ blocks [{tids.numel()}]"] = (build_segsum_plan(tids, T), tids, T)
    plans[f"sample EM lanes [{sample_tid.numel()}]"] = (build_segsum_plan(sample_tid, sample_T), sample_tid,
                                                        sample_T)
    s_cases = {}
    for name, (plan, tids, T_) in plans.items():
        require(int(plan.carry_on.sum()) > 0 or not name.startswith("one"), f"no run crosses a block at {name}")
        for dtype in (torch.float64, torch.float32, torch.int32):
            if dtype == torch.int32:
                v = torch.randint(0, 3, (tids.numel(),), generator=gen, device=DEVICE, dtype=torch.int32)
            else:
                v = torch.rand(tids.numel(), generator=gen, device=DEVICE, dtype=torch.float64).to(dtype)
            got, again, want = segsum_apply(plan, v), segsum_apply(plan, v), segsum_plain(plan, v)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"S differs from segsum_plain at {name} {dtype}")
            require(torch.equal(got, again), f"S is not bit-stable between two calls at {name} {dtype}")
            ref = torch.zeros(T_, dtype=torch.float64, device=DEVICE).index_add_(0, tids.long(), v.double())
            rel = float(((got.double() - ref).abs() / ref.abs().clamp_min(1e-300)).max())
            require(rel <= (1e-12 if dtype == torch.float64 else 1e-4 if dtype == torch.float32 else 0),
                    f"S at {name} {dtype} is {rel} relative from the float64 index_add_")
            record(results, "S", max_abs_err=float((got.double() - want.double()).abs().max()))
            s_cases[(name, dtype)] = (plan, tids, v, T_)
        print(f"[probe-segsum] S {name}: bit-equal to segsum_plain and between calls at float64, float32, int32; "
              f"{int(plan.carry_on.sum())} block carries, {plan.num_transcripts} transcripts")

    # Past 512 carry blocks (n_pad > 2^27 lanes) S's top scan takes its
    # other shape, one block of 1024 x 8: 2^27 + 153,600 lanes over the
    # c3 transcripts, float64.
    big = torch.randint(0, T, ((1 << 27) + 300 * 512,), generator=gen, device=DEVICE, dtype=torch.int32)
    plan = build_segsum_plan(big, T)
    v = torch.rand(big.numel(), generator=gen, device=DEVICE, dtype=torch.float64)
    got, again, want = segsum_apply(plan, v), segsum_apply(plan, v), segsum_plain(plan, v)
    ref = torch.zeros(T, dtype=torch.float64, device=DEVICE).index_add_(0, big.long(), v)
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(got, again) and rel <= 1e-12,
            f"S at {big.numel()} lanes: equal to segsum_plain {torch.equal(got, want)}, stable "
            f"{torch.equal(got, again)}, {rel} relative from index_add_")
    print(f"[probe-segsum] S [{big.numel()}] lanes ({plan.perm.numel() // 512 // 512 + 1} carry blocks: the top scan "
          f"at 1024 x 8), float64: bit-equal to segsum_plain and between calls, {rel:.3g} relative from index_add_")
    del big, plan, v, got, again, want, ref
    torch.cuda.empty_cache()

    # Device time: P per launch, S per whole call and per launch.
    print(f"[probe-segsum] P and S device ms, torch.profiler over {REPS} (P) and 20 (S) calls, "
          "plain / kernel / kernel / plain")
    by_shape = {}
    for name, (h, m, t, keys, row_ptr) in cases.items():
        if name.startswith("empty") or "no lane" in name:
            continue
        arg_sets = rotation((h.contiguous(), m.contiguous()), 9 * h.numel())

        def kern(h, m, t=t):
            return bucket_lookup(h, m, t.packed, shift=t.shift, mb=t.mb)

        def plain(h, m, t=t):
            return bucket_lookup_plain(h, m, t.packed, shift=t.shift, mb=t.mb)

        ms, plain_ms = in_turns(torch, kern, plain, arg_sets, "bucket_probe_kernel")
        lib_ms = device_ms(lambda h, m, keys=keys, row_ptr=row_ptr: probe(h, m, keys, row_ptr), arg_sets)
        nbytes, ops = probe_work(h, m, bucket_lookup_plain(h, m, t.packed, shift=t.shift, mb=t.mb)[1], t)
        b_ms, by = bound(nbytes, ops)
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
                     bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, shape=name, timed="per launch")
        by_shape[name] = timed
        if name == f"k=31 [{BATCH}, 32]":
            record(results, "P", **timed)
        print(f"[probe-segsum] P {name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, searchsorted probe "
              f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes), {100 * b_ms / ms:.1f}% of "
              f"bound")
    record(results, "P", by_shape=by_shape)
    by_shape = {}
    for (name, dtype), (plan, tids, v, T_) in s_cases.items():
        if not (name == f"c3 EM lanes [{n}]" or (name.startswith("sample") and dtype == torch.float64)):
            continue
        arg_sets = rotation((v,), v.numel() * v.element_size())
        idx = tids.long()

        def kern(v, plan=plan):
            return segsum_apply(plan, v)

        def plain(v, plan=plan):
            return segsum_plain(plan, v)

        def scatter(v, idx=idx, T_=T_):
            return torch.zeros(T_, dtype=v.dtype, device=DEVICE).index_add_(0, idx, v)

        ms, plain_ms = in_turns(torch, kern, plain, arg_sets, None, reps=20)
        lib_ms = device_ms(scatter, arg_sets, reps=20)
        split = launch_split_ms(kern, arg_sets, "segsum_", reps=20)
        nbytes, ops = segsum_work(plan, v.element_size())
        b_ms, by = bound(nbytes, ops)
        key = f"{name} {str(dtype)[6:]}"
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
                     bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, shape=key, timed="per call",
                     launch_ms={k: launch_ms for k, (launch_ms, _) in split.items()})
        if name.startswith("sample"):  # ROADMAP's auto condition: the plan's build beside the scatter
            timed["plan_ms"] = device_ms(lambda t, T_=T_: build_segsum_plan(t, T_), [(tids,)], reps=20)
        by_shape[key] = timed
        if name.startswith("c3") and dtype == torch.float64:
            record(results, "S", **timed)
        print(f"[probe-segsum] S {key}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, index_add_ "
              f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes), {100 * b_ms / ms:.1f}% of "
              "bound; per launch "
              + ", ".join(f"{k} {t_ms * 1e3:.2f} us ({c} traced)" for k, (t_ms, c) in split.items())
              + (f"; the plan's build {timed['plan_ms'] * 1e3:.2f} us" if "plan_ms" in timed else ""))
    record(results, "S", by_shape=by_shape)


def _csv_rows(path):
    return {r[0]: (float(r[1]), float(r[2])) for r in list(csv.reader(open(path)))[1:]}


def phase_sample():
    from sketch_rna_tpu_torch.cli import main as cli

    ex = ROOT / "examples"
    with tempfile.TemporaryDirectory() as tmp:
        idx, out, out64, out32 = (os.path.join(tmp, n) for n in ("sample.npz", "out.csv", "out64.csv", "out32.csv"))
        require(cli(["-o", "index", "-k", "31", str(ex / "sample.fa"), idx]) == 0, "index CLI failed")
        require(cli(["-o", "quant", idx, str(ex / "sample.fq"), out]) == 0, "quant with default flags failed")
        require(cli(["-o", "quant", "--em-dtype", "float64", idx, str(ex / "sample.fq"), out64]) == 0, "quant failed")
        require(cli(["-o", "quant", "--em-dtype", "float32", idx, str(ex / "sample.fq"), out32]) == 0, "quant failed")
        seg = os.path.join(tmp, "segsum.csv")
        require(cli(["-o", "quant", "--em-segsum", "on", idx, str(ex / "sample.fq"), seg]) == 0,
                "quant with --em-segsum on failed")
        expected = (ex / "sample.expected.csv").read_bytes()
        require(Path(out).read_bytes() == expected,
                "the CSV of a quant with default flags is not byte-identical to sample.expected.csv")
        require(Path(seg).read_bytes() == expected,
                "the CSV of a quant with --em-segsum on is not byte-identical to sample.expected.csv")
        require(Path(out64).read_bytes() == expected, "float64 CSV is not byte-identical to sample.expected.csv")
        a, b = _csv_rows(out32), _csv_rows(ex / "sample.expected.csv")
        require(a.keys() == b.keys(), "float32 CSV has another row set")
        rel = max(abs(x - y) / max(abs(y), 1e-9) for n in a for x, y in zip(a[n], b[n]))
        require(rel < 1e-4, f"float32 CSV max relative difference {rel}")
    print(f"[sample] default-flags, float64 and --em-segsum on CSVs byte-identical ({len(b)} rows); float32 max "
          f"relative diff {rel:.3g}")


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


def _roofline(tag, res, quant_s, config):
    """The timed quant's roofline (utils/roofline.py) from its sizes and
    stage times, printed as one JSON line: every size counted, no share of
    peak above 1.0 (the least work cannot take less than the least time)."""
    from sketch_rna_tpu_torch.utils.roofline import roofline

    sizes = res.sizes
    require(len(sizes) == 7 and all(v > 0 for v in sizes.values()), f"{tag}: sizes not all counted: {sizes}")
    out = roofline(sizes, res.timing, quant_s, res.em_iterations, 8 if config.em_dtype == "float64" else 4)
    print(f"[{tag}] roofline {json.dumps({'sizes': sizes, 'roofline': out})}")
    over = {name: stage["share"] for name, stage in out.items() if stage.get("share", 0.0) > 1.0}
    require(not over and out["summary"]["frac_of_elapsed"] <= 1.0, f"{tag}: a share of peak above 1.0: {over}")
    return out


def _timed_quant(torch, tag, index, packed, config, n_reads, ctx=None):
    """Warm-up + timed quant; returns (result, seconds, launches of the timed
    run, its peak device memory in bytes).  Prints the timed run's
    roofline, kept in ctx["roofline"][tag] when a ctx is given."""
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
          f"peak device memory {peak} bytes; {res.timing['graphs.captures']} CUDA graphs captured")
    print(f"[{tag}] EM iterations {res.em_iterations}; mapped reads {res.num_mapped}; stats {json.dumps(res.stats)}; "
          f"launches {json.dumps(launches)}")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * n_reads, f"only {res.num_mapped} reads mapped")
    require(res.stats["sketch_overflow"] == 0 and res.stats["expand_dropped"] == 0,
            f"dropped work: {res.stats}")
    line = _roofline(tag, res, quant_s, config)
    if ctx is not None:
        ctx.setdefault("roofline", {})[tag] = line
    return res, quant_s, launches, peak


def _first_batch(torch, tag, index, config, codes, lengths, L):
    """The first batch through the kernels and through the plain functions:
    equal tables, by the default route (the grouping kernel G) and by the
    plain grouping chain on the kernels' sorts.  Returns the int32 and
    int64 rows that chain's K4 sorted."""
    import numpy as np

    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index_plain
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
    want = sketch_match_step(c, n, index, config, caps, sketch=sketch_all_k, sort=row_sort_plain,
                             lookup=probe_index_plain)
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask"))
    require(same, f"{tag} first batch: kernel candidate tables differ from the plain functions'")
    dflt = sketch_match_step(c, n, index, config, caps)
    require(all(torch.equal(getattr(dflt, f), getattr(want, f)) for f in ("tid", "score", "mask")),
            f"{tag} first batch: the default route's (G's) tables differ from the plain functions'")
    print(f"[{tag}] first batch [{B}, {L}] caps {caps}: kernel tables == plain tables "
          f"({int(got.mask.sum())} candidates)")
    return c, n, caps, sorted_rows


def scale_problem(torch, ctx):
    """The scale phase's problem: 6,000 transcripts (synth_transcriptome,
    seed SEED), index built on the card, 1,000,000 reads of 100 bp (seed
    SEED, padded to 256), k = 31, float32 EM; built once."""
    if "scale" in ctx:
        return ctx["scale"]
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

    n_tx, n_reads = SCALE
    seqs = synth_transcriptome(np.random.default_rng(SEED), n_tx, 600, 2500)
    config = QuantConfig(batch_size=BATCH, em_dtype="float32")
    t0 = time.perf_counter()
    artifact = build_index(fasta_records(seqs, "SYN"), config, device=DEVICE)
    kidx = artifact.per_k[31]
    print(f"[scale] index: {n_tx} transcripts, {sum(s.size for s in seqs)} bases -> {kidx.num_keys} keys, "
          f"{kidx.postings.size} postings in {time.perf_counter() - t0:.3f} s on the card")
    codes, lengths = sample_reads(seqs, n_reads, 100, 256, seed=SEED)
    ctx["scale"] = dict(index=to_device(artifact, DEVICE), codes=codes, lengths=lengths, config=config)
    return ctx["scale"]


def phase_scale(torch, results, ctx):
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch

    sc = scale_problem(torch, ctx)
    index, codes, lengths, config = sc["index"], sc["codes"], sc["lengths"], sc["config"]
    n_reads = lengths.size
    packed = PackedReads(codes, lengths, [])
    _, _, launches, _ = _timed_quant(torch, "scale", index, packed, config, n_reads, ctx)
    require(launches["K1"] > 0 and launches["G"] > 0, f"the single-k path skipped a kernel: {launches}")
    require(launches["K2"] == launches["K3"] == 0, f"the single-k path ran a multi-k or long-read kernel: {launches}")
    require(launches["P"] == launches["K1"] == launches["E"] == launches["G"],
            f"P, E or G did not launch once a batch: {launches}")

    L = 104  # round_up(100, 8): the width the quant path cut these reads to
    c, n, (cap,), rows = _first_batch(torch, "scale", index, config, codes, lengths, L)
    key = rows[torch.int32][0]  # the event grouping sort
    f = config.sketch_fraction
    k1 = in_turns(torch, lambda c, n: fused_sketch(c, n, 31, f, cap), lambda c, n: sketch_batch(c, n, 31, f, cap),
                  rotation((c, n), c.numel() + 4 * n.numel()), "sketch")
    k4 = in_turns(torch, row_sort, row_sort_plain, rotation((key,), 4 * key.numel()), "row_sort_kernel")
    print(f"[scale] first batch, device ms: K1 [{BATCH}, {L}] cap {cap}: kernel {k1[0]:.5f}, plain {k1[1]:.5f}; "
          f"K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.5f}, plain {k4[1]:.5f}")
    record(results, "K1", launches=launches["K1"])
    record(results, "E", launches=launches["E"])
    record(results, "G", launches=launches["G"])


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
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

    (n_tx, n_reads), ks = SCALE_MULTIK, (21, 31)
    seqs = synth_transcriptome(np.random.default_rng(22), n_tx)
    config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=128, em_dtype="float32")
    reset_launches()
    t0 = time.perf_counter()
    artifact = build_index(fasta_records(seqs, "T"), config, device=DEVICE)
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
                                                           PackedReads(codes, lengths, []), config, n_reads, ctx)
    # A batch whose per-k tables spill groups again merged (K2, P, E, K4):
    # G launches once a batch that did not.
    require(launches["K2"] > 0 and 0 < launches["G"] <= launches["K2"],
            f"the multi-k path skipped a kernel: {launches}")
    require(launches["P"] == len(ks) * launches["K2"] == launches["E"],
            f"P or E did not launch once a k and batch: {launches}")
    segsum_launches = phase_segsum_quant(torch, ctx)

    L = 104
    c, n, caps, rows = _first_batch(torch, "scale-multik", index, config, codes, lengths, L)
    f = config.sketch_fraction
    k2 = in_turns(torch, lambda c, n: fused_sketch_multik(c, n, ks, f, caps),
                  lambda c, n: sketch_all_k(c, n, ks, f, caps), rotation((c, n), c.numel() + 4 * n.numel()),
                  "sketch")
    key = max(rows[torch.int32], key=lambda x: x.shape[1])  # the widest int32 sort of the batch
    tables = rows[torch.int64][0]  # the (tid << 32) | score rows of the combine
    k4 = in_turns(torch, row_sort, row_sort_plain, rotation((key,), 4 * key.numel()), "row_sort_kernel")
    k4w = in_turns(torch, row_sort, row_sort_plain, rotation((tables,), 8 * tables.numel()), "row_sort_kernel")
    print(f"[scale-multik] first batch, device ms: K2 [{BATCH}, {L}] ks {ks} caps {caps}: kernel {k2[0]:.5f}, "
          f"plain {k2[1]:.5f}; K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.5f}, plain {k4[1]:.5f}; "
          f"K4-int64 [{BATCH}, {tables.shape[1]}]: kernel {k4w[0]:.5f}, plain {k4w[1]:.5f}")
    record(results, "K2", launches=launches["K2"])
    record(results, "P", launches=launches["P"])
    record(results, "S", launches=segsum_launches)


def phase_segsum_quant(torch, ctx):
    """The c3 stand-in at float64: the default route (index_add_), then
    --em-segsum on twice.  The two segsum runs give bit-identical pi and
    counts, within 1e-9 relative of the default; S launches once an EM
    iteration and twice in the assignment.  Returns S's launches of one
    run."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import quantify

    c3 = c3_problem(torch, ctx)
    packed = PackedReads(c3["codes"], c3["lengths"], [])
    cfg = dataclasses.replace(c3["config"], em_dtype="float64")
    t0 = time.perf_counter()
    ref = ctx["c3_fused64"] = quantify(c3["index"], packed, cfg)
    torch.cuda.synchronize()
    print(f"[scale-multik] float64 quant, default EM route: {time.perf_counter() - t0:.3f} s, em_assign "
          f"{ref.timing['em_assign']:.4f} s")
    seg = dataclasses.replace(cfg, em_segsum="on")
    runs = []
    for _ in range(2):
        reset_launches()
        res = quantify(c3["index"], packed, seg)
        torch.cuda.synchronize()
        runs.append((res, read_launches()))
    (a, la), (b, _) = runs
    require(np.array_equal(a.pi, b.pi) and np.array_equal(a.weighted_counts, b.weighted_counts),
            "two --em-segsum on float64 quants differ")
    rel = max(_rel_diff(a.pi, ref.pi), _rel_diff(a.weighted_counts[ref.has_entry], ref.weighted_counts[ref.has_entry]))
    require(np.array_equal(a.has_entry, ref.has_entry) and a.em_iterations == ref.em_iterations and rel <= 1e-9,
            f"--em-segsum on differs from the default route by {rel} relative")
    require(la["S"] == a.em_iterations + 2, f"S launched {la['S']} times in {a.em_iterations} EM iterations")
    print(f"[scale-multik] --em-segsum on, float64, twice: pi and counts bit-identical between the runs, within "
          f"{rel:.3g} relative of the default route; em_assign {a.timing['em_assign']:.4f} / "
          f"{b.timing['em_assign']:.4f} s; S launches {la['S']} ({a.em_iterations} iterations + 2)")
    return la["S"]


def _crosscheck_batches(torch, tag, problem):
    """Every batch of a problem, as the fused engine forms it (match_rows,
    merged regroups included), through the row matcher (sketch_match_step:
    K1 / K2, P, E, G, and K4 and the merge where G does not take a batch)
    and through the global-sort matcher
    (match/candidates.py: the searchsorted probe, one flat expansion,
    torch.sort), both on the same kernel-made sketches: equal tid, score,
    mask and candidate_spilled, and no event dropped under a budget of the
    batch's most events a read (from P's run lengths).  Then the graph
    path (match_rows' default: match_scan, its steps replayed from CUDA
    graphs) on the same reads: tables and stats equal to that eager
    per-batch run's; the graphs it captured and its peak memory.  Then
    four more graph-path calls on the same index (two repeats, one under
    another chain fraction, one more under the first config): each equal
    to its config's eager path, and the repeats capture nothing."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
    from sketch_rna_tpu_torch.match.candidates import match_batch
    from sketch_rna_tpu_torch.pipeline import match_rows, sketch_match_step
    from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads
    from sketch_rna_tpu_torch.utils.timing import PhaseTimer

    index, codes, lengths, config = problem["index"], problem["codes"], problem["lengths"], problem["config"]
    ks = tuple(index.kmer_lengths)
    per_k = [index.per_k[k] for k in ks]
    done = {"batches": 0, "candidates": 0, "first_passes": 0}

    def checked_step(c, n, index, cfg, caps):
        sketches = sketch_reads(c, n, ks, cfg.sketch_fraction, caps)
        row = sketch_match_step(c, n, index, cfg, caps, sketch=lambda *_: sketches)
        if len(ks) > 1 and cfg.match_per_k_tables and int(row.stats["candidate_spilled_per_k"]):
            done["first_passes"] += 1  # match_rows regroups this batch merged: compared then
            return row
        most = max(int(length.sum(dim=1).max()) for _, length in
                   (probe_index(h, m, ki) for (h, m, _), ki in zip(sketches, per_k)))
        glob = match_batch([h for h, _, _ in sketches], [m for _, m, _ in sketches], [ki.keys for ki in per_k],
                           [ki.row_ptr for ki in per_k], [ki.postings for ki in per_k],
                           chain_fraction=cfg.chain_fraction, expand_per_read=max(most, 1),
                           candidate_capacity=cfg.candidate_capacity)
        b = done["batches"]
        require(int(glob.stats["expand_dropped"].sum()) == 0, f"{tag} batch {b}: the global-sort matcher dropped "
                f"{glob.stats['expand_dropped'].tolist()} events under a budget of {most} a read")
        same = all(torch.equal(getattr(row, f), getattr(glob, f)) for f in ("tid", "score", "mask"))
        require(same and int(row.stats["candidate_spilled"]) == int(glob.stats["candidate_spilled"]),
                f"{tag} batch {b}: the row matcher's tables differ from the global-sort matcher's")
        done["batches"] += 1
        done["candidates"] += int(row.mask.sum())
        return row

    t0 = time.perf_counter()
    tid, score, n_padded, stats = match_rows(index, torch.from_numpy(codes), lengths, config, step=checked_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(done["batches"] == n_padded // config.batch_size == -(-lengths.size // config.batch_size),
            f"{tag}: {done['batches']} batches compared of {n_padded // config.batch_size}")
    # The graph path (match_rows' default, match_scan) against that eager
    # per-batch run: equal tables and stats, every batch.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with PhaseTimer().opened() as timer:
        g_tid, g_score, g_padded, g_stats = match_rows(index, torch.from_numpy(codes), lengths, config)
    torch.cuda.synchronize()
    g_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(torch.equal(g_tid, tid) and torch.equal(g_score, score) and g_padded == n_padded
            and all(int(g_stats[k]) == int(stats[k]) for k in stats),
            f"{tag}: the graph path's tables or stats differ from the eager per-batch path's")
    g_batches = timer.counts["match.group_kernel_batches"]
    require(g_batches > 0, f"{tag}: the graph path grouped no batch through G")
    print(f"[crosscheck] {tag}: {lengths.size} reads, k = {ks}: all {done['batches']} batches' row-matcher tables "
          f"== the global-sort matcher's ({done['candidates']} candidates compared, 0 events dropped, "
          f"{done['first_passes']} per-k spills regrouped first, candidate_spilled {int(stats['candidate_spilled'])}) "
          f"in {seconds:.1f} s; the graph path (match_scan) == that eager path, tables and stats, every batch "
          f"({timer.counts['graphs.captures']} graphs captured, {g_batches} of {done['batches']} batches grouped by "
          f"G, {g_seconds:.3f} s, peak device memory {peak} bytes)")
    # The graphs live with the index: two more calls replay them, a call
    # under another chain fraction captures its own, and the first config
    # after it replays again; each equal to its config's eager path.
    base = (tid, score, n_padded, stats)
    other = dataclasses.replace(config, chain_fraction=0.5 if config.chain_fraction != 0.5 else 0.9)
    runs = (("repeat", config, base), ("repeat", config, base),
            (f"chain_fraction {other.chain_fraction}", other,
             match_rows(index, torch.from_numpy(codes), lengths, other, step=sketch_match_step)),
            ("after it", config, base))
    counts = []
    for name, cfg, want in runs:
        with PhaseTimer().opened() as timer:
            got = match_rows(index, torch.from_numpy(codes), lengths, cfg)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
                and all(int(got[3][k]) == int(want[3][k]) for k in want[3]),
                f"{tag}: the graph path's {name} call on one index differs from the eager per-batch path")
        counts.append((name, timer.counts["graphs.captures"], timer.counts["graphs.replays"]))
    require(counts[0][1] == counts[1][1] == counts[3][1] == 0,
            f"{tag}: a repeated call on one index captured graphs: {counts}")
    print(f"[crosscheck] {tag}: later graph-path calls on the same index == the eager path, tables and stats "
          f"(call, graphs captured, replayed): {counts}")


def _crosscheck_oracle(torch):
    """ORACLE_PROBLEM on the card against the C++ tool's math in NumPy
    (oracle/): collect_pairs' candidates of every read equal
    oracle_sparse_chain's (its top C by score desc, tid asc), with nothing
    dropped or overflowed; quantify's CSV rows equal oracle_quant's, pi
    and NumReads within 5e-9 relative (float64 EM, PARITY.md deviation 6)."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.oracle import oracle_quant
    from sketch_rna_tpu_torch.pipeline import collect_pairs, quantify
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

    n_tx, n_reads = ORACLE_PROBLEM
    ks = (21, 31)
    seqs = synth_transcriptome(np.random.default_rng(SEED), n_tx)
    config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=128, em_dtype="float64")
    t0 = time.perf_counter()
    index = to_device(build_index(fasta_records(seqs, "O"), config, device=DEVICE), DEVICE)
    codes, lengths = sample_reads(seqs, n_reads, 100, config.max_read_len, seed=SEED)
    packed = PackedReads(codes, lengths, [])
    reads, tids, scores, stats = collect_pairs(index, packed, config)
    res = quantify(index, packed, config)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    segments, pi, weighted, csv_tids = oracle_quant(
        seqs, {i: codes[i, : lengths[i]] for i in range(n_reads)}, ks, config.sketch_fraction,
        config.chain_fraction, config.em_max_iterations, config.em_convergence)
    oracle_s = time.perf_counter() - t0
    C = config.candidate_capacity
    spill = sum(max(len(cands) - C, 0) for cands in segments.values())
    require(stats["sketch_overflow"] == 0 and stats["expand_dropped"] == 0 and stats["candidate_spilled"] == spill,
            f"oracle problem: loss stats {stats}, the oracle's candidates past C: {spill}")
    got = [[] for _ in range(n_reads)]
    for r, t, sc in zip(reads.tolist(), tids.tolist(), scores.tolist()):
        got[r].append((t, sc))
    bad = [i for i in range(n_reads) if got[i] != segments[i][:C]]
    require(not bad, f"oracle problem: {len(bad)} reads' candidates differ from oracle_sparse_chain's, "
                     f"first {bad[:3]}: {[(got[i], segments[i]) for i in bad[:1]]}")
    rows = [t for t in range(n_tx) if res.has_entry[t]]
    require(res.num_reads == len(segments) and rows == csv_tids,
            f"oracle problem: CSV rows {len(rows)} against the oracle's {len(csv_tids)}")
    d_pi, d_counts = _rel_diff(res.pi, pi), _rel_diff(res.weighted_counts[rows], weighted[rows])
    require(d_pi <= 5e-9 and d_counts <= 5e-9, f"oracle problem: pi {d_pi}, NumReads {d_counts} relative")
    print(f"[crosscheck] oracle: {n_tx} transcripts, {n_reads} reads, k = {ks}, float64: collect_pairs == "
          f"oracle_sparse_chain ({reads.size} pairs, candidates past C {spill}, loss stats 0); CSV rows {len(rows)} "
          f"== oracle_quant's, pi within {d_pi:.3g}, NumReads within {d_counts:.3g} relative; card (index build, "
          f"collect_pairs, quantify) {card_s:.1f} s, oracle on the host {oracle_s:.1f} s")


def phase_crosscheck(torch, ctx):
    """The card's main path against independent formulations at scale:
    every batch of scale and the c3 problem against the global-sort
    matcher, ORACLE_PROBLEM against the reference math, and the scale
    phases' roofline lines (run here if those phases did not run)."""
    from sketch_rna_tpu_torch.io.packing import PackedReads

    problems = (("scale", scale_problem(torch, ctx)), ("scale-multik", c3_problem(torch, ctx)))
    for tag, problem in problems:
        _crosscheck_batches(torch, tag, problem)
    _crosscheck_oracle(torch)
    rooflines = ctx.setdefault("roofline", {})
    for tag, p in problems:
        if tag not in rooflines:
            _timed_quant(torch, tag, p["index"], PackedReads(p["codes"], p["lengths"], []), p["config"],
                         p["lengths"].size, ctx)
        summary = rooflines[tag]["summary"]
        print(f"[crosscheck] {tag} roofline: {summary['dominant_bound']} leads at "
              f"{summary['frac_of_peak']:.3g} of its peak; the stages' least time is "
              f"{summary['frac_of_elapsed']:.3g} of the quant's")


def phase_fuzz(torch, results, smi):
    """The seeded trials of sketch_rna_tpu_torch.oracle.fuzz (as
    scripts/fuzz_oracle_torch.py runs them) on the card: trial i
    of FUZZ_TRIALS takes regime i mod 8 (fused one k; fused 2-3 ks;
    streamed, tiny buffers; sharded (1, 1); long reads; --em-segsum on;
    nine ks; 20 kb reads at sketch fraction 0.9), every other knob drawn
    from its seed.  Each trial holds collect_pairs to oracle_sparse_chain
    exactly, pi and NumReads to oracle_quant within 5e-9 relative and the
    CSV rows exactly, or is skipped for a capacity stat (sketch_overflow,
    candidate_spilled): at most a tenth may be.  Every kernel of
    counters() must launch in the phase, the merge's partition launch
    included."""
    from sketch_rna_tpu_torch.oracle import fuzz

    compared, skipped = 0, {}
    worst = {"pi_rel": 0.0, "numreads_rel": 0.0}
    by_regime = {regime: {} for regime in fuzz.REGIMES}  # launches summed over each regime's trials
    reset_launches()
    t0 = time.perf_counter()
    for i in range(FUZZ_TRIALS):
        seed, regime = FUZZ_BASE + i, fuzz.REGIMES[i % len(fuzz.REGIMES)]
        before = read_launches()
        try:
            info = fuzz.one_trial(seed, DEVICE, regime)
        except AssertionError as exc:
            require(False, f"fuzz seed {seed} ({regime}) differs from the oracle: {exc}; the draw: "
                           f"{fuzz.describe(fuzz.draw(seed, regime))}")
        if "skipped" in info:
            skipped[seed] = info["skipped"]
        else:
            compared += 1
            worst = {key: max(v, info[key]) for key, v in worst.items()}
        took = {name: n - before[name] for name, n in read_launches().items() if n > before[name]}
        for name, n in took.items():
            by_regime[regime][name] = by_regime[regime].get(name, 0) + n
        print(f"[fuzz] {i + 1}/{FUZZ_TRIALS} seed={seed} {regime}: {'skipped' if 'skipped' in info else 'ok'} "
              f"{json.dumps(info)} launches {json.dumps(took)}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for name in KERNELS:
        record(results, name, fuzz_launches=launches[name])
    record(results, "merge", fuzz_partition_launches=launches["merge-partition"])
    print("[fuzz] summary " + json.dumps({
        "trials": FUZZ_TRIALS, "compared": compared, "skipped": len(skipped), "skipped_stats": skipped,
        "launches": launches, "launches_by_regime": by_regime, "max_pi_rel": worst["pi_rel"],
        "max_numreads_rel": worst["numreads_rel"], "seconds": round(seconds, 1), "card": smi}))
    require(len(skipped) <= FUZZ_TRIALS // 10, f"fuzz: {len(skipped)} of {FUZZ_TRIALS} trials skipped: {skipped}")
    idle = sorted(name for name, n in launches.items() if n == 0)
    require(not idle, f"fuzz: kernels never launched in the phase: {idle}")
    _heavy_read_batch(torch, smi)


def _heavy_read_batch(torch, smi):
    """A full batch (BATCH reads of 100 bp, k = 31, sketch fraction 0.9)
    that holds one read from a 300-way shared core, ~24,000 events: that
    read groups in a row slice of its own (rowmatch.match_runs), so the
    batch's event rows stay as narrow as without it and its peak device
    memory near the same batch's without it, below that plus the
    [BATCH, W] int32 event row the heavy read would widen it to; the
    tables equal the plain functions' and, but for the heavy read's,
    the light batch's; match_scan groups it the same way."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index_plain
    from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, row_sort_plain, row_sort_wide
    from sketch_rna_tpu_torch.pipeline import match_scan, sketch_match_step
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

    rng = np.random.default_rng(24)
    seqs = synth_transcriptome(rng, 2000)
    core = rng.integers(0, 4, 150).astype(np.uint8)
    seqs += [np.concatenate([f[0], core, f[1]]) for f in rng.integers(0, 4, (300, 2, 30)).astype(np.uint8)]
    config = QuantConfig(kmer_lengths=(31,), sketch_fraction=0.9)
    index = to_device(build_index(fasta_records(seqs, "T"), config, device=DEVICE), DEVICE)
    codes, lengths = sample_reads(seqs[:2000], BATCH, 100, 128, seed=24)
    heavy, heavy_lengths = codes.copy(), lengths.copy()
    heavy[0], heavy_lengths[0] = 0, 120
    heavy[0, :120] = core[:120]
    caps = (config.sketch_capacity_for(31, 128),)
    wide = []

    def recording(x):
        if x.shape[1] > MAX_WIDTH:
            wide.append(tuple(x.shape))
        return row_sort_wide(x)

    def run(c, n, **kw):
        c, n = torch.from_numpy(c).to(DEVICE), torch.from_numpy(n).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = sketch_match_step(c, n, index, config, caps, **kw)
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base

    light, light_peak = run(codes, lengths)
    require(not wide, f"heavy-read batch: the light batch sorted rows past {MAX_WIDTH} lanes: {wide}")
    got, peak = run(heavy, heavy_lengths, sort=recording)
    want, _ = run(heavy, heavy_lengths, sketch=sketch_all_k, sort=row_sort_plain, lookup=probe_index_plain)
    require(len(wide) == 1 and wide[0][0] == 1, f"heavy-read batch: rows past {MAX_WIDTH} lanes sorted as {wide}")
    require(all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask")),
            "heavy-read batch: kernel tables differ from the plain functions'")
    require(all(torch.equal(getattr(got, f)[1:], getattr(light, f)[1:]) for f in ("tid", "score", "mask")),
            "heavy-read batch: the other reads' tables differ from the light batch's")
    # The same batch through the graph path: its heavy batch groups in row
    # slices eagerly, as the per-batch route does.
    s_tid, s_score, _, s_stats = match_scan(index, torch.from_numpy(heavy), heavy_lengths, config)
    require(torch.equal(s_tid, got.tid) and torch.equal(s_score, got.score)
            and int(s_stats["candidate_spilled"]) == int(got.stats["candidate_spilled"]),
            "heavy-read batch: match_scan's tables differ from sketch_match_step's")
    unsliced = BATCH * wide[0][1] * 4
    require(peak < light_peak + unsliced, f"heavy-read batch: peak {peak} B against {light_peak} B without the "
                                          f"heavy read: the batch widened")
    print("[fuzz] heavy-read batch " + json.dumps({
        "reads": BATCH, "heavy_row": wide[0], "peak_bytes": peak,
        "peak_bytes_without_it": light_peak, "unsliced_int32_row_bytes": unsliced,
        "candidate_spilled": int(got.stats["candidate_spilled"]), "card": smi}))


def phase_spill(torch, results):
    """Per-k table spill on the card: the batch regroups merged, equal to a
    forced merged run and, through the graph path, to the eager per-batch
    path; the regroup's sort_event_parts runs the merge kernel."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import match_rows, quantify, sketch_match_step
    from sketch_rna_tpu_torch.utils.synth import fasta_records

    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 80).astype(np.uint8)
    seqs = [np.concatenate([core, rng.integers(0, 4, 60).astype(np.uint8)]) for _ in range(300)]
    config = QuantConfig(kmer_lengths=(15, 31), candidate_capacity=8, batch_size=32, em_dtype="float64")
    index = to_device(build_index(fasta_records(seqs, "T"), config, device=DEVICE), DEVICE)
    codes = np.zeros((48, 128), np.uint8)
    codes[:32, :70] = core[:70]
    for i in range(32, 48):
        codes[i, :70] = seqs[i][70:140]
    packed = PackedReads(codes, np.full(48, 70, np.int32), [])
    merged = dataclasses.replace(config, match_per_k_tables=False)
    tid, score, _, stats = match_rows(index, torch.from_numpy(codes), packed.lengths, config)
    m_tid, m_score, _, m_stats = match_rows(index, torch.from_numpy(codes), packed.lengths, merged)
    e_tid, e_score, _, e_stats = match_rows(index, torch.from_numpy(codes), packed.lengths, config,
                                            step=sketch_match_step)
    require(torch.equal(tid, e_tid) and torch.equal(score, e_score)
            and all(int(stats[k]) == int(e_stats[k]) for k in stats),
            "the graph path's regrouped tables differ from the eager per-batch path's")
    require(int(stats["candidate_spilled_per_k"]) > 0, "the per-k tables did not spill")
    require(torch.equal(tid, m_tid) and torch.equal(score, m_score), "regrouped tables differ from the merged run")
    require(int(stats["candidate_spilled"]) == int(m_stats["candidate_spilled"]) > 0, "candidate_spilled differs")
    reset_launches()
    a = quantify(index, packed, config)
    torch.cuda.synchronize()
    launches = read_launches()
    b = quantify(index, packed, merged)
    require(np.array_equal(a.has_entry, b.has_entry) and np.allclose(a.pi, b.pi, rtol=1e-9, atol=0),
            "spill quant differs from the forced merged quant")
    require(launches["merge"] > 0, f"the merged regroup did not merge through the merge kernel: {launches}")
    print(f"[spill] per-k spill {int(stats['candidate_spilled_per_k'])} -> merged regroup; tables == forced "
          f"merged run; candidate_spilled {int(stats['candidate_spilled'])}; quant launches {json.dumps(launches)}")
    record(results, "merge", launches=launches["merge"])


def _dedup_widths(c, n, ks, fraction, caps):
    """The row widths that the long route's dedup sorts see on one batch."""
    from sketch_rna_tpu_torch.sketch import dispatch

    widths, real = [], dispatch.row_sort_wide

    def recording(x):
        widths.append(x.shape[1])
        return real(x)

    dispatch.row_sort_wide = recording
    try:
        dispatch.sketch_reads(c, n, ks, fraction, caps)
    finally:
        dispatch.row_sort_wide = real
    return widths


def phase_long_reads(torch, results):
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_kept
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads, synth_transcriptome

    (n_tx, n_reads), read_len = LONG_READS, 2000
    seqs = synth_transcriptome(np.random.default_rng(SEED + 1), n_tx, 3000, 8000)
    config = QuantConfig(batch_size=BATCH, em_dtype="float32")
    index = to_device(build_index(fasta_records(seqs, "L"), config, device=DEVICE), DEVICE)
    # Reads from the transcripts that hold a whole read: every read has
    # 1970 windows at k = 31, so none takes the fused kernels.
    long_enough = [s for s in seqs if s.size >= read_len]
    codes, lengths = sample_reads(long_enough, n_reads, read_len, 2048, seed=SEED + 1)
    require(int(lengths.min()) == read_len, "a long-read sample is shorter than the read length")
    _, _, launches, _ = _timed_quant(torch, "long-reads", index, PackedReads(codes, lengths, []), config, n_reads)
    require(launches["K3"] > 0 and launches["K4-int64"] > 0 and launches["K1"] == 0,
            f"long reads did not sketch through K3 + K4-int64 alone: {launches}")
    require(launches["P"] == -(-n_reads // BATCH), f"the probe did not launch P once a batch: {launches}")
    L = read_len  # round_up(2000, 8)
    c, n, caps, _ = _first_batch(torch, "long-reads", index, config, codes, lengths, L)
    f = config.sketch_fraction
    widths = _dedup_widths(c, n, (31,), f, caps)
    require(0 < max(widths) <= 256, f"the 2,000 bp dedup sorted at widths {widths}, not at most 256 lanes")
    k3 = in_turns(torch, lambda c, n: nthash_sketch(c, n, 31, f), lambda c, n: hash_kept(c, n, 31, f),
                  rotation((c, n), c.numel() + 4 * n.numel()), None)
    print(f"[long-reads] first batch: dedup sort widths {widths}; device ms per call: K3 [{BATCH}, {L}] k=31: "
          f"kernel {k3[0]:.5f}, plain {k3[1]:.5f}")
    record(results, "K3", launches=launches["K3"])
    record(results, "K4-int64", launches=launches["K4-int64"])
    del c, n

    # 20 kb reads (nk_pad 32768): their ~1,000 kept hashes a read sort on
    # K4-int64 alone, never through row_sort_wide's merges.
    n_tx, n_reads, read_len = VERY_LONG
    seqs = synth_transcriptome(np.random.default_rng(SEED + 2), n_tx, read_len, read_len + 4000)
    index = to_device(build_index(fasta_records(seqs, "V"), config, device=DEVICE), DEVICE)
    codes, lengths = sample_reads([s for s in seqs if s.size >= read_len], n_reads, read_len, read_len,
                                  seed=SEED + 2)
    require(int(lengths.min()) == read_len, "a very long read is shorter than the read length")
    _, _, launches, _ = _timed_quant(torch, "very-long-reads", index, PackedReads(codes, lengths, []), config,
                                        n_reads)
    require(launches["K3"] > 0 and launches["K4-int64"] > 0 and launches["K1"] == 0 and launches["merge"] == 0,
            f"20 kb reads did not sketch through K3 + K4-int64 alone: {launches}")
    c, n, caps, _ = _first_batch(torch, "very-long-reads", index, config, codes, lengths, read_len)
    widths = _dedup_widths(c, n, (31,), config.sketch_fraction, caps)
    require(max(widths) <= 1 << 14, f"the 20 kb dedup sorted at widths {widths}, past K4's widest row")
    print(f"[very-long-reads] first batch: dedup sort widths {widths}")


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
    if "c3_fused64" not in ctx:  # else scale-multik's float64 run, timed there
        t0 = time.perf_counter()
        ctx["c3_fused64"] = quantify(c3["index"], packed, config)
        print(f"[stream] fused float64 quant of {packed.num_reads} reads: {time.perf_counter() - t0:.3f} s")
    fused = ctx["c3_fused64"]
    print(f"[stream] the fused float64 quant took {fused.em_iterations} EM iterations")
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


def _merge_shapes(torch, step, codes, lengths, index, config, caps):
    """The (rows, row width, key type) of each merge kernel launch of one
    batch through `step`, and the batch's launches of every kernel.  The
    batch's first row sort is sort_event_parts' one launch over the P
    parts of every row, [B * P, w]; its merge rounds follow from that."""
    from sketch_rna_tpu_torch.match.row_sort import row_sort

    sorted_shapes = []

    def recording(x):
        sorted_shapes.append((x.shape[0], x.shape[1], str(x.dtype)[6:]))
        return row_sort(x)

    reset_launches()
    step(codes, lengths, index, config, caps, sort=recording)
    launches = read_launches()
    rows, w, dtype_name = sorted_shapes[0]
    shapes = []
    while rows > codes.shape[0]:
        rows, w = rows // 2, w * 2
        shapes.append([rows, w, dtype_name])
    return shapes, launches


def rank_worker(rank: int, world: int, port: int, workdir: str, device_type: str) -> int:
    """One rank process of the sharded phase: joins the process group,
    runs every mesh of workdir/plan.json on the problem saved there, and
    writes per mesh its result (.npz) and its measurements (.json)."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.dist.init import init_distributed, pick_backend, rank_device, shutdown
    from sketch_rna_tpu_torch.dist.mesh import make_mesh
    from sketch_rna_tpu_torch.dist.quant_stream import match_batch_sharded
    from sketch_rna_tpu_torch.index.artifact import load_index
    from sketch_rna_tpu_torch.index.shard import device_index_bytes, shard_to_device
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import quantify_sharded

    require(device_type == "cpu" or torch.cuda.is_available(), f"rank {rank} found no CUDA device")
    backend = pick_backend(device_type, world)
    init_distributed(f"localhost:{port}", world, rank, device_type=device_type, backend=backend, timeout_s=300)
    try:
        device = rank_device(device_type)
        on_card = device.type == "cuda"
        with open(os.path.join(workdir, "plan.json")) as fh:
            plan = json.load(fh)
        knobs = dict(plan["config"], kmer_lengths=tuple(plan["config"]["kmer_lengths"]))
        config = QuantConfig(**knobs)
        artifact = load_index(plan["index"])
        codes, lengths = np.load(plan["codes"]), np.load(plan["lengths"])
        packed = PackedReads(codes, lengths, [])
        n_reads = packed.num_reads
        for dp, ip in plan["meshes"]:
            mesh = make_mesh(dp, ip, device)
            shard = shard_to_device(artifact, ip, mesh.i, device)
            quantify_sharded(shard, packed, config, mesh)  # warm-up at full size
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            res = quantify_sharded(shard, packed, config, mesh)
            if on_card:
                torch.cuda.synchronize()
            own_s = time.perf_counter() - t0
            launches = read_launches()
            dist.barrier()
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            # One batch of this rank's reads again, to record its launches
            # and the merge kernel's shapes (collective over the index group).
            r0, r1 = (n_reads * mesh.d) // dp, (n_reads * (mesh.d + 1)) // dp
            L = plan["l_eff"]
            c = torch.from_numpy(np.ascontiguousarray(packed.codes[r0 : r0 + config.batch_size, :L])).to(device)
            n = torch.from_numpy(lengths[r0 : r0 + config.batch_size]).to(device)
            caps = tuple(config.sketch_capacity_for(k, L) for k in config.kmer_lengths)
            merged = dataclasses.replace(config, match_per_k_tables=False)
            step = functools.partial(match_batch_sharded, index_group=mesh.index_group)
            shapes, batch_launches = _merge_shapes(torch, step, c, n, shard, merged, caps)
            tag = f"{dp}x{ip}.rank{rank}"
            np.savez(os.path.join(workdir, f"{tag}.npz"), pi=res.pi, weighted=res.weighted_counts,
                     has_entry=res.has_entry)
            with open(os.path.join(workdir, f"{tag}.json"), "w") as fh:
                json.dump(dict(mesh=[dp, ip], rank=rank, d=mesh.d, i=mesh.i, backend=mesh.backend, device=str(device),
                               own_s=own_s, wall_s=wall_s, peak_bytes=peak, index_bytes=device_index_bytes(shard),
                               batches=-(-(r1 - r0) // config.batch_size), launches=launches,
                               batch_launches=batch_launches, merge_shapes=shapes, iterations=res.em_iterations,
                               num_reads=res.num_reads, num_mapped=res.num_mapped, stats=res.stats,
                               timing=res.timing), fh)
    finally:
        shutdown()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_ranks(commands, what, timeout_s, log_dir, **popen_kw):
    """Start one process per command and wait for all.  The first rank to
    fail, or the time limit, ends the wait: the rest are killed and the
    phase fails with every rank's output shown.  Returns the outputs."""
    logs = [os.path.join(log_dir, f"rank{rank}.log") for rank in range(len(commands))]
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, **popen_kw)
             for cmd, fh in zip(commands, files)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [rank for rank, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} of {what} exited with code {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"{what} did not finish in {timeout_s} s"
            else:
                time.sleep(0.2)
        bad = [rank for rank, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} of {what} exited with code {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fh in files:
            fh.close()
    outs = [Path(path).read_text() for path in logs]
    if failed:
        for rank, out in enumerate(outs):
            print(f"---- output of rank {rank} of {what} ----\n{out[-6000:]}")
        require(False, failed)
    return outs


def _check_against(name, got_pi, got_weighted, got_has, iterations, stats, ref):
    import numpy as np

    rel = max(_rel_diff(got_pi, ref.pi), _rel_diff(got_weighted, ref.weighted_counts))
    require(np.array_equal(got_has, ref.has_entry), f"sharded ({name}) CSV rows differ from the fused run's")
    require(iterations == ref.em_iterations, f"sharded ({name}) ran {iterations} EM iterations, fused "
            f"{ref.em_iterations}")
    require(rel <= 1e-9, f"sharded ({name}) differs from the fused run by {rel} relative")
    for key in ("sketch_overflow", "expand_dropped", "candidate_spilled", "candidate_spilled_per_k",
                "class_overflow", "wide_spilled"):
        require(stats[key] == ref.stats.get(key, 0) == 0, f"sharded ({name}) loss stat {key}={stats[key]}")
    return rel


def phase_sharded(torch, results, ctx, smi):
    """The multi-GPU route at the c3 width, held to the fused run."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.dist.init import pick_backend
    from sketch_rna_tpu_torch.dist.mesh import index_device_bytes, make_mesh
    from sketch_rna_tpu_torch.dist.quant_stream import match_batch_sharded
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.index.shard import shard_to_device
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.row_sort import bitonic_merge_pair, merge_pairs, row_sort_plain
    from sketch_rna_tpu_torch.pipeline import quantify, quantify_sharded
    from sketch_rna_tpu_torch.utils.roofline import bound, merge_work

    c3 = c3_problem(torch, ctx)
    config = dataclasses.replace(c3["config"], em_dtype="float64")
    packed = PackedReads(c3["codes"], c3["lengths"], [])
    n_reads = packed.num_reads
    on_card = DEVICE == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    worlds = [w for w, _ in SHARDED_WORLDS]
    print(f"[sharded] device_count {n_cards}; backend of the rank processes: "
          + ", ".join(f"{w} ranks -> {pick_backend(DEVICE, w)}" for w in worlds)
          + ("" if n_cards >= max(worlds) else
             f"; fewer cards than ranks: the ranks share cuda:0 and the collectives go over gloo through host "
             f"memory, so reads/s here measures the route's overhead, not scaling"))
    ref = ctx.get("c3_fused64") or quantify(c3["index"], packed, config)
    whole_bytes = index_device_bytes(c3["artifact"])
    report = {}

    # Mesh (1, 1) in this process: the engine with no process group.
    mesh = make_mesh(1, 1, device=torch.device(DEVICE))
    quantify_sharded(c3["artifact"], packed, config, mesh)  # warm-up
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = quantify_sharded(c3["artifact"], packed, config, mesh)
    if on_card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rel = _check_against("1x1", res.pi, res.weighted_counts, res.has_entry, res.em_iterations, res.stats, ref)
    batches = -(-n_reads // BATCH)
    print(f"[sharded] mesh (1, 1) in-process: {n_reads} reads in {secs:.3f} s, {n_reads / secs:.1f} reads/s; max "
          f"relative difference to fused {rel:.3g}; peak device memory {peak} bytes; index bytes {whole_bytes}; "
          f"launches {json.dumps(launches)} over {batches} batches; stages (s) "
          f"{json.dumps({k: round(v, 4) for k, v in res.timing.items()})}")
    require(launches["K2"] > 0 and launches["K4"] > 0 and launches["merge"] >= batches,
            f"the sharded route skipped a kernel or a batch's merge: {launches}")
    require(launches["P"] == 0, f"the sharded route probed through the bucket table: {launches}")
    record(results, "merge", launches=launches["merge"], partition_launches=launches["merge-partition"])
    record(results, "K4", launches=launches["K4"])
    c = torch.from_numpy(np.ascontiguousarray(c3["codes"][:BATCH, :104])).to(DEVICE)
    n = torch.from_numpy(c3["lengths"][:BATCH]).to(DEVICE)
    caps = tuple(config.sketch_capacity_for(k, 104) for k in config.kmer_lengths)
    shapes, per_batch = _merge_shapes(torch, match_batch_sharded, c, n, shard_to_device(c3["artifact"], 1, 0, DEVICE),
                                      config, caps)
    print(f"[sharded] mesh (1, 1): one batch launches {json.dumps(per_batch)}; its merge launches (rows, width, type) "
          f"{shapes}")
    report["1x1"] = dict(reads_per_s=n_reads / secs, peak_bytes=[peak], index_bytes=[whole_bytes],
                         launches_per_batch=per_batch, merge_shapes=shapes)
    del c, n

    with tempfile.TemporaryDirectory() as tmp:
        idx_path, codes_path, lengths_path = (os.path.join(tmp, n) for n in ("c3.npz", "codes.npy", "lengths.npy"))
        save_index(idx_path, c3["artifact"])
        np.save(codes_path, c3["codes"])
        np.save(lengths_path, c3["lengths"])
        knobs = dataclasses.asdict(config)
        for world, meshes in SHARDED_WORLDS:
            workdir = os.path.join(tmp, f"world{world}")
            os.mkdir(workdir)
            with open(os.path.join(workdir, "plan.json"), "w") as fh:
                json.dump(dict(index=idx_path, codes=codes_path, lengths=lengths_path, config=knobs, l_eff=104,
                               meshes=[list(m) for m in meshes]), fh)
            port = _free_port()
            t0 = time.perf_counter()
            _run_ranks([[sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", str(rank), str(world),
                         str(port), workdir, DEVICE] for rank in range(world)],
                       f"the {world}-rank world", RANK_JOIN_S, workdir, cwd=ROOT)
            print(f"[sharded] {world} rank processes ran meshes {meshes} in {time.perf_counter() - t0:.1f} s")
            for dp, ip in meshes:
                tag = f"{dp}x{ip}"
                ranks = []
                for rank in range(world):
                    with open(os.path.join(workdir, f"{tag}.rank{rank}.json")) as fh:
                        info = json.load(fh)
                    with np.load(os.path.join(workdir, f"{tag}.rank{rank}.npz")) as z:
                        info.update(pi=z["pi"], weighted=z["weighted"], has_entry=z["has_entry"])
                    ranks.append(info)
                r0 = ranks[0]
                rels = []
                for info in ranks:
                    require(on_card == info["device"].startswith("cuda"), f"rank {info['rank']} computed on "
                            f"{info['device']}")
                    rels.append(_check_against(f"{tag} rank {info['rank']}", info["pi"], info["weighted"],
                                               info["has_entry"], info["iterations"], info["stats"], ref))
                    require(np.array_equal(info["pi"], r0["pi"]) and np.array_equal(info["weighted"], r0["weighted"]),
                            f"rank {info['rank']} of mesh {tag} does not hold rank 0's result")
                    require(info["num_reads"] == n_reads and info["num_mapped"] == ref.num_mapped,
                            f"mesh {tag} rank {info['rank']} counted {info['num_reads']} reads, "
                            f"{info['num_mapped']} mapped")
                    per_batch = info["batch_launches"]
                    require(per_batch["K2"] == 1 and per_batch["K4"] >= 1 and per_batch["K3"] == per_batch["K1"] == 0
                            and per_batch["merge"] == len(info["merge_shapes"]) >= 1 and per_batch["P"] == 0
                            and info["launches"]["P"] == 0,
                            f"mesh {tag} rank {info['rank']}: one batch launched {per_batch}")
                    require(info["launches"]["merge"] == info["batches"] * per_batch["merge"]
                            and info["launches"]["K2"] == info["batches"],
                            f"mesh {tag} rank {info['rank']}: {info['launches']} over {info['batches']} batches")
                wall = max(info["wall_s"] for info in ranks)
                idx_bytes = [info["index_bytes"] for info in ranks]
                require(max(idx_bytes) <= (0.6 if ip == 2 else 1.01) * whole_bytes,
                        f"mesh {tag}: index bytes per rank {idx_bytes} against {whole_bytes} for one replica")
                print(f"[sharded] mesh ({dp}, {ip}) over {r0['backend']}, ranks on {sorted({i['device'] for i in ranks})}: "
                      f"{n_reads} reads in {wall:.3f} s, {n_reads / wall:.1f} reads/s; max relative difference to "
                      f"fused {max(rels):.3g}; every rank holds rank 0's result")
                print(f"[sharded] mesh ({dp}, {ip}) per rank: peak device memory {[i['peak_bytes'] for i in ranks]} "
                      f"bytes; index bytes {idx_bytes} (one replica {whole_bytes}); batches "
                      f"{[i['batches'] for i in ranks]}; launches of rank 0 {json.dumps(r0['launches'])}; per batch "
                      f"{json.dumps(r0['batch_launches'])}; merge launches of one batch (rows, width, type) "
                      f"{r0['merge_shapes']}; stages of rank 0 (s) "
                      f"{json.dumps({k: round(v, 4) for k, v in r0['timing'].items()})}")
                report[tag] = dict(reads_per_s=n_reads / wall, backend=r0["backend"],
                                   peak_bytes=[i["peak_bytes"] for i in ranks], index_bytes=idx_bytes,
                                   launches_per_batch=r0["batch_launches"], merge_shapes=r0["merge_shapes"])

    # The merge kernel at the gathered shapes, alone on the card.
    if on_card:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        timed = {}
        for tag, entry in report.items():
            total_ms = total_bound = 0.0
            for rows, width, dtype_name in entry.get("merge_shapes", []):
                key = (rows, width, dtype_name)
                if key not in timed:
                    dtype = getattr(torch, dtype_name)
                    x = _halves(torch, _keys(torch, gen, rows, width, dtype), width // 2)
                    nbytes, ops = merge_work(rows, width, x.element_size())

                    def plain(x, w=width // 2):
                        return bitonic_merge_pair(x[:, :w], x[:, w:])

                    require(torch.equal(merge_pairs(x), plain(x)),
                            f"merge_pairs differs from bitonic_merge_pair at [{rows}, {width}] {dtype_name}")
                    arg_sets = rotation((x,), nbytes // 2)
                    ms, plain_ms = in_turns(torch, merge_pairs, plain, arg_sets, None)
                    sort_ms = device_ms(row_sort_plain, arg_sets)  # the yardstick: torch.sort of the rows
                    b_ms, by = bound(nbytes, ops)
                    timed[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=sort_ms, bound_ms=b_ms, bound_by=by)
                    print(f"[sharded] merge [{rows}, {width}] {dtype_name} (a gathered batch's round): kernel "
                          f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, torch.sort {sort_ms * 1e3:.2f} us, "
                          f"bound {b_ms * 1e3:.3f} us ({by}), {100 * b_ms / ms:.1f}% of bound")
                    del x
                total_ms += timed[key]["ms"]
                total_bound += timed[key]["bound_ms"]
            if entry.get("merge_shapes"):
                entry.update(merge_ms_per_batch=total_ms, merge_bound_ms_per_batch=total_bound)
                print(f"[sharded] mesh {tag}: the merge kernel takes {total_ms * 1e3:.2f} us of device time per batch "
                      f"in {len(entry['merge_shapes'])} launches (bound {total_bound * 1e3:.3f} us)")
        entry_timed = {f"[{r}, {w}] {t}": v for (r, w, t), v in timed.items()}
    else:
        entry_timed = {}
    record(results, "merge", sharded=dict(meshes=report, rounds=entry_timed))

    # The CLI as two rank processes, each parsing its byte range of the sample.
    ex = ROOT / "examples"
    with tempfile.TemporaryDirectory() as tmp:
        from sketch_rna_tpu_torch.cli import main as cli

        idx, out = os.path.join(tmp, "sample.npz"), os.path.join(tmp, "out.csv")
        extra = [] if on_card else ["--device", "cpu"]
        require(cli(["-o", "index", *extra, str(ex / "sample.fa"), idx]) == 0, "index CLI failed")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT), SKETCH_TPU_DIST_TIMEOUT="120")
        outs = _run_ranks([[sys.executable, "-m", "sketch_rna_tpu_torch.cli", "-o", "quant", *extra, "--coordinator",
                             f"localhost:{port}", "--num-processes", "2", "--process-id", str(rank), idx,
                             str(ex / "sample.fq"), out] for rank in range(2)],
                          "the two-rank CLI", 240, tmp, cwd=ROOT, env=env)
        route = [ln for o in outs for ln in o.splitlines() if ln.startswith("quant route:")]
        writers = sum("Output written" in o for o in outs)
        require(writers == 1 and "Output written" in outs[0], f"{writers} processes wrote the CSV, not rank 0 alone")
        require(len(route) == 1 and route[0].startswith("quant route: sharded (dp=2, ip=1, "),
                f"the two-rank CLI took another route: {route}")
        require(Path(out).read_bytes() == (ex / "sample.expected.csv").read_bytes(),
                "the two-rank CLI's CSV is not byte-identical to sample.expected.csv")
    print(f"[sharded] two-rank CLI with --coordinator, each rank its byte range of sample.fq: {route[0]!r}; rank 0's "
          f"CSV byte-identical to sample.expected.csv, one writer")
    print(f"[sharded] card (name, power limit): {smi}")


def _c3_chunks(seqs, n_reads, chunk, seed):
    """2-bit chunks of 100 bp reads, made chunk by chunk from seed + c."""
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    for c, r0 in enumerate(range(0, n_reads, chunk)):
        codes, lengths = sample_reads(seqs, min(chunk, n_reads - r0), 100, 104, seed=seed + c)
        yield PackedReads(codes, lengths, []).bit_packed()


def phase_stream_c3(torch, ctx):
    """BASELINE config 3 at 10M reads through the streamed engine."""
    import dataclasses

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
    if ctx.get("fused_peak_bytes"):
        require(peak <= 1.5 * ctx["fused_peak_bytes"], "stream-c3's peak device memory exceeds 1.5x the fused run's")
    require(res.num_reads == C3_READS, f"{res.num_reads} reads quantified")
    require(np.isfinite(res.pi).all() and np.isfinite(res.weighted_counts).all(), "non-finite EM output")
    for key in ("sketch_overflow", "expand_dropped", "candidate_spilled", "class_overflow", "wide_spilled"):
        require(st[key] == 0, f"stream-c3 lost work: {key}={st[key]}")
    total = float(res.weighted_counts[res.has_entry].sum())
    require(abs(total - res.num_mapped) <= 1e-3 * res.num_mapped,
            f"sum of NumReads {total} != reads with a candidate {res.num_mapped}")
    require(res.num_mapped > 0.9 * C3_READS, f"only {res.num_mapped} reads mapped")
    require(launches["K2"] > 0 and 0 < launches["G"] <= launches["K2"],
            f"the streamed multi-k path skipped a kernel: {launches}")
    require(launches["P"] == 2 * launches["K2"], f"the streamed probe did not launch P once a k and batch: {launches}")
    print(f"[stream-c3] bucket tables {json.dumps(index.bucket_bytes())} bytes per k, inside the peak above")

    # The same feed once more at float64 EM, the CLI's default.
    cfg64 = dataclasses.replace(config, em_dtype="float64")
    t0 = time.perf_counter()
    res64 = quantify_streamed(index, _c3_chunks(seqs, C3_READS, chunk, 9000), cfg64, num_reads_hint=C3_READS)
    torch.cuda.synchronize()
    secs64 = time.perf_counter() - t0
    rel = _rel_diff(res.pi, res64.pi)
    print(f"[stream-c3] float64 EM: {C3_READS} reads in {secs64:.3f} s, {C3_READS / secs64:.1f} reads/s; em_assign "
          f"{res64.timing['em_assign']:.4f} s in {res64.em_iterations} iterations (float32: "
          f"{res.timing['em_assign']:.4f} s in {res.em_iterations}); the float32 pi within {rel:.3g} relative of it")
    require(np.isfinite(res64.pi).all() and res64.num_mapped == res.num_mapped
            and all(res64.stats[key] == 0 for key in ("sketch_overflow", "expand_dropped", "class_overflow")),
            f"the float64 streamed run lost work or mapped other reads: {res64.stats}")


def phase_cli_stream(torch, ctx):
    """The CLI past the fused bound: the streamed route over the native scan."""
    import io

    import numpy as np

    from sketch_rna_tpu_torch.cli import main as cli
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.stream import quantify_streamed
    from sketch_rna_tpu_torch.utils.synth import sample_reads, write_fastq

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
        write_fastq(fq, codes, lengths)
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
        want = f"quant route: streamed, feed: {'native-scan' if has_native else 'python'}, em: scatter"
        require(route == [want], f"the CLI took another route: {route}, expected {want!r}")
        got = _csv_rows(out)
    ref = quantify_streamed(c3["index"], PackedReads(codes, lengths, []), c3["config"])
    want_rows = {ref.names[t]: (float(ref.weighted_counts[t]), float(ref.pi[t]))
                 for t in np.flatnonzero(ref.has_entry)}
    require(got.keys() == want_rows.keys(), f"CLI CSV rows ({len(got)}) != in-process rows ({len(want_rows)})")
    rel = max(abs(x - y) / max(abs(y), 1e-9) for n in got for x, y in zip(got[n], want_rows[n]))
    require(rel <= 1e-4, f"CLI CSV differs from in-process quantify_streamed by {rel} relative")
    print(f"[cli-stream] CSV == in-process quantify_streamed ({len(got)} rows, max rel diff {rel:.3g})")


def gencode_indexes(torch, seqs, launches, kss=((31,), (21, 31))):
    """The GENCODE-scale indexes built on the card, k = 31 and ks (21, 31)
    (or those of kss), each k held to the JAX package's build
    (GENCODE_INDEX) bit for bit: {ks: (artifact, DeviceIndex)}.  K3's
    launches go into `launches`."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import GENCODE_INDEX, fasta_records

    recs = fasta_records(seqs, "T")
    n_bases = sum(s.size for s in seqs)
    out = {}
    for ks in kss:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        artifact = build_index(recs, QuantConfig(kmer_lengths=ks), device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        built = read_launches()
        launches.update(built)
        # One K3 call a 2^22-window chunk of the flat codes, a k.
        chunks = sum(-(-(n_bases - k + 1) // (1 << 22)) for k in ks)
        require(built["K3"] == chunks, f"gencode build ks {ks}: K3 launched {built['K3']} times, not {chunks}")
        for k in ks:
            ki = artifact.per_k[k]
            got = (ki.num_keys, int(ki.postings.size), ki.sha256())
            require(got == GENCODE_INDEX[k], f"gencode build ks {ks}, k={k}: (keys, postings, sha256) {got} != the "
                                             f"JAX package's {GENCODE_INDEX[k]}")
        t0 = time.perf_counter()
        index = to_device(artifact, DEVICE)
        upload_s = time.perf_counter() - t0
        for k in ks:
            ki, di = artifact.per_k[k], index.per_k[k]
            host = ki.keys.nbytes + ki.row_ptr.nbytes + ki.postings.nbytes
            dev = sum(t.numel() * t.element_size() for t in (di.keys, di.row_ptr, di.postings)) + di.bucket.nbytes
            t = di.bucket
            print(f"[gencode] index ks {ks}, k={k}: {ki.num_keys} keys, {ki.postings.size} postings, sha256 "
                  f"{ki.sha256()[:16]}... == the JAX package's; {host} bytes on the host, {dev} on the card; "
                  f"bucket table {t.packed.shape[0]} buckets x {t.packed.shape[1]} int32 lanes (deepest bucket "
                  f"{t.mb} keys, mean {ki.num_keys / t.packed.shape[0]:.2f}), {t.nbytes} bytes")
        print(f"[gencode] index ks {ks}: {len(seqs)} transcripts, {n_bases} bases built in {build_s:.3f} s on the "
              f"card (K3 {built['K3']} calls), peak device memory {peak} bytes; upload + bucket tables "
              f"{upload_s:.3f} s")
        out[ks] = (artifact, index)
    return out


@contextlib.contextmanager
def _top_c_keys(counts):
    """Counts the key type of every top-C selection (match/rowmatch.py
    _smallest: int32 packed (rank, tid) keys, or int64) while in use."""
    from sketch_rna_tpu_torch.match import rowmatch

    inner = rowmatch._smallest

    def spy(keys, C, sort):
        counts[str(keys.dtype)[6:]] += 1
        return inner(keys, C, sort)

    rowmatch._smallest = spy
    try:
        yield
    finally:
        rowmatch._smallest = inner


def phase_gencode(torch, results, ctx):
    """GENCODE width on the card: both 250k-transcript indexes equal to the
    JAX package's, the fused quants of 2^20 150 bp reads at k = 31 and
    ks (21, 31), float64, against the global-sort matcher and the streamed
    engine, and 8,388,608 reads from a FASTQ through the CLI.  The
    transcriptome, indexes and reads stay in ctx["gencode"] for stages."""
    import collections
    import dataclasses
    import io

    import numpy as np

    from sketch_rna_tpu_torch.cli import main as cli
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.pipeline import LOSS_KEYS, quantify
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k, sketch_batch
    from sketch_rna_tpu_torch.stream import quantify_streamed
    from sketch_rna_tpu_torch.utils.roofline import bound, sketch_work
    from sketch_rna_tpu_torch.utils.synth import GENCODE_TRANSCRIPTS as n_tx
    from sketch_rna_tpu_torch.utils.synth import gencode_transcriptome, sample_reads, write_fastq

    n_reads = GENCODE_READS
    path = collections.Counter()  # launches of the phase's main-path runs
    t0 = time.perf_counter()
    seqs = gencode_transcriptome()
    print(f"[gencode] transcriptome: {n_tx} transcripts, {sum(s.size for s in seqs)} bases "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    indexes = gencode_indexes(torch, seqs, path)
    codes, lengths = sample_reads(seqs, n_reads, 150, 256, seed=7)
    packed = PackedReads(codes, lengths, [])
    print(f"[gencode] {n_reads} reads of up to 150 bp (seed 7, padded to 256; {int((lengths < 150).sum())} shorter, "
          f"from transcripts that short)")
    ctx["gencode"] = dict(seqs=seqs, indexes=indexes, codes=codes, lengths=lengths)

    for ks, (_, index) in indexes.items():
        tag = f"gencode k={','.join(map(str, ks))}"
        config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=256, em_dtype="float64")
        res, _, timed, _ = _timed_quant(torch, tag, index, packed, config, n_reads)
        path.update(timed)
        require(all(res.stats[key] == 0 for key in LOSS_KEYS), f"{tag}: lost work {res.stats}")
        _crosscheck_batches(torch, tag, dict(index=index, codes=codes, lengths=lengths, config=config))
        reset_launches()
        t0 = time.perf_counter()
        st = quantify_streamed(index, packed, config)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        path.update(read_launches())
        rel = max(_rel_diff(st.pi, res.pi), _rel_diff(st.weighted_counts[res.has_entry],
                                                      res.weighted_counts[res.has_entry]))
        require(np.array_equal(st.has_entry, res.has_entry) and st.em_iterations == res.em_iterations
                and st.num_mapped == res.num_mapped and rel <= 1e-9,
                f"{tag}: the streamed engine differs from the fused run by {rel} relative")
        print(f"[{tag}] streamed == fused within {rel:.3g} relative ({int(res.has_entry.sum())} rows, "
              f"{res.em_iterations} EM iterations; streamed {stream_s:.3f} s, {st.stats['stream_classes']} classes)")
        if ks == (31,):
            reset_launches()
            seg = quantify(index, packed, dataclasses.replace(config, em_segsum="on"))
            torch.cuda.synchronize()
            seg_launches = read_launches()
            path.update(seg_launches)
            rel = max(_rel_diff(seg.pi, res.pi), _rel_diff(seg.weighted_counts[res.has_entry],
                                                           res.weighted_counts[res.has_entry]))
            require(np.array_equal(seg.has_entry, res.has_entry) and rel <= 1e-9
                    and seg_launches["S"] == seg.em_iterations + 2,
                    f"{tag} --em-segsum on: {rel} relative from the default route, S {seg_launches['S']} launches")
            print(f"[{tag}] --em-segsum on: within {rel:.3g} relative of the default route over {n_tx} "
                  f"transcripts; em_assign {seg.timing['em_assign']:.4f} s against {res.timing['em_assign']:.4f} s; "
                  f"S {seg_launches['S']} launches")
        # The first batch as the path forms it (256-padded rows cut to the
        # longest read rounded up to 8) through the kernels and the plain
        # functions, then K1 (k = 31) or K2 (ks 21, 31) held to its plain
        # version there and timed.
        L = 152
        c, n, caps, _ = _first_batch(torch, tag, index, config, codes, lengths, L)
        f = config.sketch_fraction
        if ks == (31,):
            name, kern, plain, params = "K1", fused_sketch, sketch_batch, (31, f, caps[0])
        else:
            name, kern, plain, params = "K2", fused_sketch_multik, sketch_all_k, (ks, f, caps)
        shape = f"[{c.shape[0]}, {L}] ks {ks} caps {caps}"
        got, want = (r if ks == (31,) else sum(map(tuple, r), ()) for r in (kern(c, n, *params), plain(c, n, *params)))
        require(same_tensors(torch, got, want), f"{tag}: {name} differs from its plain version at {shape}")
        record(results, name, max_abs_err=max_err(got, want))
        arg_sets = [(a, b, *params) for a, b in rotation((c, n), c.numel() + 4 * n.numel())]
        ms, plain_ms = in_turns(torch, kern, plain, arg_sets, "sketch")
        nbytes, ops = sketch_work(c.shape[0], L, ks, caps)
        b_ms, by = bound(nbytes, ops)
        record(results, name, gencode=dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                           bound_share=b_ms / ms))
        print(f"[{tag}] {name} {shape} (the 256-padded reads as the path cuts them): == its plain version; "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes, "
              f"{ops} operations), {100 * b_ms / ms:.1f}% of bound")
        if ks == (31,):
            _time_expand(torch, results, tag, index, c, n, caps, f)
        _time_group(torch, results, tag, index, config, c, n, caps)
        del c, n, got, want

    _reserved_growth(torch, indexes[(31,)][1], packed,
                     QuantConfig(kmer_lengths=(31,), batch_size=BATCH, max_read_len=256, em_dtype="float64"))

    # File to CSV: a FASTQ of GENCODE_FILE_READS reads through the CLI.
    artifact, index = indexes[(31,)]
    config = QuantConfig(batch_size=BATCH)  # the CLI's defaults: k from the index, float64 EM
    require(native.native_available(), "the native FASTQ parser did not build")
    fcodes, flengths = sample_reads(seqs, GENCODE_FILE_READS, 150, 152, seed=71)
    with tempfile.TemporaryDirectory() as tmp:
        fq, idx, out = (os.path.join(tmp, n) for n in ("reads.fq", "gencode.npz", "out.csv"))
        t0 = time.perf_counter()
        size = write_fastq(fq, fcodes, flengths)
        save_index(idx, artifact)
        print(f"[gencode] wrote {GENCODE_FILE_READS} reads ({size} bytes) and the k=31 index in "
              f"{time.perf_counter() - t0:.2f} s")
        err = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli(["-o", "quant", "--device", DEVICE, idx, fq, out])
        secs = time.perf_counter() - t0
        cli_launches = read_launches()
        path.update(cli_launches)
        route = [line for line in err.getvalue().splitlines() if line.startswith("quant route:")]
        print(f"[gencode] CLI quant of {GENCODE_FILE_READS} reads in {secs:.3f} s ({GENCODE_FILE_READS / secs:.1f} "
              f"reads/s; index load, parse and CSV included): {route}; launches {json.dumps(cli_launches)}")
        require(rc == 0, f"gencode CLI quant failed: {err.getvalue()[-2000:]}")
        want = "quant route: streamed, feed: native-lazy, em: scatter"
        require(route == [want], f"the CLI took another route: {route}, expected {want!r}")
        got = _csv_rows(out)
    t0 = time.perf_counter()
    ref = quantify_streamed(index, PackedReads(fcodes, flengths, []), config)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    require(all(ref.stats[key] == 0 for key in LOSS_KEYS), f"gencode in-process stream lost work: {ref.stats}")
    want_rows = {ref.names[t]: (float(ref.weighted_counts[t]), float(ref.pi[t])) for t in np.flatnonzero(ref.has_entry)}
    require(got.keys() == want_rows.keys(), f"CLI CSV rows ({len(got)}) != in-process rows ({len(want_rows)})")
    rel = max(abs(x - y) / max(abs(y), 1e-9) for n in got for x, y in zip(got[n], want_rows[n]))
    require(rel <= 1e-4, f"the CLI's CSV differs from in-process quantify_streamed by {rel} relative")
    print(f"[gencode] CLI CSV == in-process quantify_streamed of the same codes ({len(got)} rows, max rel diff "
          f"{rel:.3g}; in-process {ref_s:.3f} s, {GENCODE_FILE_READS / ref_s:.1f} reads/s from host codes)")

    print(f"[gencode] launches on the phase's main-path runs (builds, timed quants, streamed runs, segsum, CLI): "
          f"{json.dumps(dict(path))}")
    missing = [k for k in ("K1", "K2", "K3", "G", "P", "E") if path[k] < 1]
    require(not missing, f"gencode: kernels never launched: {missing}")
    for name in results:
        record(results, name, launches_gencode=path[name])


def _reserved_growth(torch, index, packed, config, calls=RESERVED_CALLS):
    """`calls` quants of the same reads on one index, as a process that
    quantifies sample after sample does: the card's reserved memory may
    grow by under RESERVED_GROWTH_MIB after the first two calls (the match
    stage's CUDA graphs live with the index, so later calls capture
    nothing and add no graph pool)."""
    from sketch_rna_tpu_torch.pipeline import quantify
    from sketch_rna_tpu_torch.utils.timing import PhaseTimer

    t0 = time.perf_counter()
    captures, captured_bytes = [], 0
    for i in range(calls):
        if i == 2:
            torch.cuda.synchronize()
            after_two = torch.cuda.memory_reserved()
        with PhaseTimer().opened() as timer:
            quantify(index, packed, config)
        captures.append(timer.counts["graphs.captures"])
        captured_bytes += timer.counts["graphs.reserved_bytes"]
    torch.cuda.synchronize()
    growth = (torch.cuda.memory_reserved() - after_two) / 2**20
    secs = time.perf_counter() - t0
    print(f"[gencode k=31] {calls} quants on one index in {secs:.1f} s: reserved memory "
          f"{after_two / 2**30:.3f} GiB after the first two, grew {growth:.1f} MiB over the other {calls - 2}; "
          f"graphs captured: {captures[:2]} in the first two, {sum(captures[2:])} after, reserving "
          f"{captured_bytes / 2**20:.1f} MiB in all")
    require(growth < RESERVED_GROWTH_MIB and sum(captures[2:]) == 0,
            f"reserved memory grew {growth:.1f} MiB over {calls - 2} quants on one index "
            f"(bound {RESERVED_GROWTH_MIB} MiB), {sum(captures[2:])} graphs captured after the first two")


def phase_graph_store(torch, ctx):
    """The graph store past its bound (see the module docstring): every
    call equal to its config's eager path, evictions in the first round,
    no reserved memory grown after the second."""
    import collections
    import dataclasses

    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.pipeline import length_groups, match_rows, sketch_match_step
    from sketch_rna_tpu_torch.utils.step_graphs import MAX_GRAPHS
    from sketch_rna_tpu_torch.utils.synth import gencode_transcriptome, sample_reads
    from sketch_rna_tpu_torch.utils.timing import PhaseTimer

    if "gencode" in ctx:
        seqs, index = ctx["gencode"]["seqs"], ctx["gencode"]["indexes"][(31,)][1]
    else:
        seqs = gencode_transcriptome()
        index = gencode_indexes(torch, seqs, collections.Counter(), kss=((31,),))[(31,)][1]
    # Whole transcripts (all under 2,560 bases), each cut to a length drawn
    # uniformly from 500-2,560, as the long-read mix cuts its reads.
    codes, lengths = sample_reads(seqs, GRAPH_STORE_READS, 2560, 2560, seed=21)
    lengths = np.minimum(lengths, np.random.default_rng(21).integers(500, 2561, lengths.size)).astype(np.int32)
    codes[np.arange(2560)[None, :] >= lengths[:, None]] = 0
    groups = [(pad, int(lengths[rows].size)) for pad, rows in length_groups(lengths, 2560)]
    base = QuantConfig(kmer_lengths=(31,), batch_size=BATCH, em_dtype="float64")
    configs = [dataclasses.replace(base, chain_fraction=f) for f in GRAPH_STORE_CHAINS]
    codes_t = torch.from_numpy(codes)
    want = [match_rows(index, codes_t, lengths, cfg, step=sketch_match_step) for cfg in configs]
    store = index.graphs
    rounds = []
    for r in range(GRAPH_STORE_ROUNDS):
        counts = collections.Counter()
        for cfg, w in zip(configs, want):
            with PhaseTimer().opened() as timer:
                got = match_rows(index, codes_t, lengths, cfg)
            require(torch.equal(got[0], w[0]) and torch.equal(got[1], w[1]) and got[2] == w[2]
                    and all(int(got[3][k]) == int(w[3][k]) for k in w[3]),
                    f"graph-store round {r}, chain fraction {cfg.chain_fraction}: the graph path's tables or stats "
                    f"differ from the eager per-batch path's")
            counts.update({k: timer.counts[k] for k in ("graphs.captures", "graphs.replays", "graphs.evictions",
                                                        "match.eager_batches")})
        torch.cuda.synchronize()
        rounds.append(dict(counts, reserved=torch.cuda.memory_reserved(), kept=len(store.entries)))
    growth = (rounds[-1]["reserved"] - rounds[1]["reserved"]) / 2**20
    print(f"[graph-store] {GRAPH_STORE_READS} reads of 500-2,560 bases on the GENCODE k = 31 index, length groups "
          f"(pad, reads) {groups}, chain fractions {GRAPH_STORE_CHAINS}: every call == its eager per-batch path; "
          f"per round {[{k: v for k, v in c.items()} for c in rounds]}; reserved memory grew {growth:.1f} MiB "
          f"after round 2 (store bound {MAX_GRAPHS})")
    first = rounds[0]
    require(first["graphs.captures"] > MAX_GRAPHS and first["graphs.evictions"] > 0
            and all(c["kept"] == MAX_GRAPHS for c in rounds),
            f"graph-store: the first round captured {first['graphs.captures']} graphs and evicted "
            f"{first['graphs.evictions']}; the store should pass its bound of {MAX_GRAPHS}")
    require(growth < RESERVED_GROWTH_MIB,
            f"graph-store: reserved memory grew {growth:.1f} MiB after the second round (bound "
            f"{RESERVED_GROWTH_MIB} MiB)")


def _time_expand(torch, results, tag, index, c, n, caps, f):
    """E on the first GENCODE batch's k = 31 posting runs (K1 and P on
    the card), at the width the path gives them: equal to row_expand_plain,
    then timed per launch against it (in turns), with its bound from this
    batch's events."""
    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
    from sketch_rna_tpu_torch.match.expand import row_expand, row_expand_plain
    from sketch_rna_tpu_torch.match.rowmatch import expand_width
    from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads
    from sketch_rna_tpu_torch.utils.roofline import bound, expand_work

    h, m, _ = sketch_reads(c, n, (31,), f, caps)[0]
    start, length = probe_index(h, m, index.per_k[31])
    totals = length.sum(dim=1)
    W = expand_width(int(totals.max()))
    post = index.per_k[31].postings
    got, want = row_expand(start, length, post, W), row_expand_plain(start, length, post, W)
    require(torch.equal(got, want), f"{tag}: E differs from row_expand_plain on the first batch's runs")
    arg_sets = [(s, ln, post, W) for s, ln in rotation((start, length), 16 * start.numel())]
    ms, plain_ms = in_turns(torch, row_expand, row_expand_plain, arg_sets, "row_expand_kernel")
    B, S = start.shape
    events = int(totals.clamp(max=W).sum())
    nbytes, ops = expand_work(length, W)
    b_ms, by = bound(nbytes, ops)
    shape = f"[{B}, {S}] runs -> [{B}, {W}] events, k=31"
    record(results, "E", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
           bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, library_ms=None, shape=shape,
           timed="per launch", events=events, max_abs_err=0)
    print(f"[{tag}] E {shape} (the first batch's runs, {events} events): == row_expand_plain; kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes, {ops} operations), "
          f"{100 * b_ms / ms:.1f}% of bound")


def gencode_problem(torch, ctx):
    """The gencode phase's transcriptome, indexes and 2^20 reads: its own
    when it ran, else built the same way (the indexes on the card, held
    to the JAX build's digests)."""
    if "gencode" not in ctx:
        import collections

        from sketch_rna_tpu_torch.utils.synth import gencode_transcriptome, sample_reads

        seqs = gencode_transcriptome()
        codes, lengths = sample_reads(seqs, GENCODE_READS, 150, 256, seed=7)
        ctx["gencode"] = dict(seqs=seqs, indexes=gencode_indexes(torch, seqs, collections.Counter()), codes=codes,
                              lengths=lengths)
    return ctx["gencode"]


def phase_stages(torch, results, ctx, smi):
    """The first per-stage device profile at GENCODE width, through the
    profile scripts' functions (scripts/profile_*_torch.py): the step's
    stages and the EM at 250,000 transcripts, k = 31 and (21, 31); the
    multi-k decomposition; the posterior-sum strategies over the k = 31
    EM tables' width tiers and over the same classes padded into one
    [M, W] table; the host feed of a 2,097,152-read FASTQ; and one fused
    2^20-read float64 quant at k = 31 under torch.profiler.  Checks on
    the phase's own batch and EM tables: the chained stages equal
    sketch_match_step, which equals its plain route, S equals
    segsum_plain and gives the same bits twice (profile_scatter's
    checks), and the tiers hold fewer lanes than the single table, the
    same nonzero ones.  match_scan (the graph path) is measured per batch
    at both k sets, and the traced quant's match stage must synchronize
    at most once a length group plus once (its stats) and dispatch at most
    a tenth of the per-batch route's 98.6 torch operations a batch; so
    must a two-group input's match stage synchronize, and neither may
    upload from pageable memory (match_stage_trace); nor may a group's
    upload wait for queued device work (upload_wait)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_em_scatter_torch
    import profile_feed_torch
    import profile_multik_torch
    import profile_step_torch

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.match.bucket_lookup import probe_index_plain
    from sketch_rna_tpu_torch.match.row_sort import row_sort_plain
    from sketch_rna_tpu_torch.pipeline import quantify, sketch_match_step
    from sketch_rna_tpu_torch.sketch.fracminhash import sketch_all_k
    from sketch_rna_tpu_torch.utils.profiling import (device_ms_by_name, host_ops, read_launches, reset_launches,
                                                      traced)
    from sketch_rna_tpu_torch.utils.synth import sample_reads, write_fastq

    dev = torch.device(DEVICE)
    g = gencode_problem(torch, ctx)
    codes, lengths = g["codes"], g["lengths"]
    T = len(g["seqs"])
    line = {"card": smi, "transcripts": T, "reads": int(lengths.size), "step": {}, "scan": {}, "em": {}}
    tables = {}
    for ks, (_, index) in g["indexes"].items():
        tag = ",".join(map(str, ks))
        config = QuantConfig(kmer_lengths=ks, batch_size=BATCH, max_read_len=256, em_dtype="float64")
        c, n, caps = profile_step_torch.first_batch(index, codes, lengths, BATCH)
        try:
            line["step"][tag] = profile_step_torch.profile_stages(index, config, c, n, caps)
        except AssertionError as exc:
            require(False, f"stages ks {ks}: {exc}")
        got = sketch_match_step(c, n, index, config, caps)
        want = sketch_match_step(c, n, index, config, caps, sketch=sketch_all_k, sort=row_sort_plain,
                                 lookup=probe_index_plain)
        require(all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("tid", "score", "mask")),
                f"stages ks {ks}: the kernel route's tables differ from the plain route's on the GENCODE batch")
        tables[ks] = profile_step_torch.class_tables(index, config, codes, lengths)
        try:
            line["em"][tag] = profile_step_torch.profile_em(*tables[ks], int(lengths.size), T, config)
        except AssertionError as exc:
            require(False, f"stages ks {ks}: {exc}")
        line["scan"][tag] = profile_step_torch.profile_scan(index, config, codes, lengths)
        scan = line["scan"][tag]
        print(f"[stages] ks {ks} match_scan over {scan['batches']} batches (codes on the card), per batch: wall "
              f"{scan['wall_ms']:.4f} ms, device {scan['device_ms']:.4f} ms, host "
              + json.dumps({k: round(v, 2) for k, v in scan["host_ops"].items()})
              + f"; {scan['graphs_a_call']} graphs a call; synchronizing calls a call {json.dumps(scan['syncs_a_call'])}"
              + "; one call's split (ms) " + json.dumps({where: {k: round(v, 2) for k, v in split.items()}
                                                          for where, split in scan["split_ms"].items()}))
        em = line["em"][tag]
        print(f"[stages] ks {ks} [{c.shape[0]}, {c.shape[1]}]: chained stages == sketch_match_step == its plain "
              f"route; device ms {json.dumps({s: m['device_ms'] for s, m in line['step'][tag].items()})}; EM tables "
              f"(rows x width) {', '.join(f'{r} x {w}' for r, w in em['tiers'])}, {em['lanes']} lanes, device ms "
              f"{json.dumps({s: em[s]['device_ms'] for s in STEP_EM})}")
        del c, n, got, want

    try:
        line["multik"] = profile_multik_torch.profile_multik(g["indexes"][(21, 31)][1], codes, lengths, BATCH, dev)
    except AssertionError as exc:
        require(False, f"stages multik: {exc}")
    print("[stages] t(21) + t(31) against t(21, 31): " + json.dumps(line["multik"]["sum_vs_both"]))

    # The posterior-sum strategies over the k = 31 tiers, then over the
    # same classes padded back into one [M, W] table (the layout the
    # port ran its EM over before it had tiers).
    tiers = tables[(31,)][0]
    del tables
    for key, tabs in (("em_scatter", tiers), ("em_scatter_single", [profile_em_scatter_torch.single_layout(tiers)])):
        try:
            line[key] = profile_em_scatter_torch.profile_scatter(tabs, T, dev, chained=False)
        except AssertionError as exc:
            require(False, f"stages {key}: {exc}")
        out = line[key]
        print(f"[stages] {key}: S == segsum_plain, bit-stable, on the GENCODE EM tables (rows x width) "
              f"{', '.join(f'{r} x {w}' for r, w in out['tables'])}: {out['lanes']} lanes, {out['zero_lanes']} of "
              "them zero; device ms per posterior sum "
              + json.dumps({k: v["device_ms"] for k, v in out["strategies"].items()}))
        del tabs
    tiered, single = line["em_scatter"], line["em_scatter_single"]
    require(tiered["lanes"] < single["lanes"] and tiered["lanes"] - tiered["zero_lanes"]
            == single["lanes"] - single["zero_lanes"],
            f"stages: the tiers hold {tiered['lanes']} lanes against the single table's {single['lanes']}")
    del tiers

    fcodes, flengths = sample_reads(g["seqs"], STAGES_FEED_READS, 150, 152, seed=71)
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, fcodes, flengths)
        del fcodes, flengths
        try:
            line["feed"] = profile_feed_torch.profile_feed(fq, 1 << 20, 31, BATCH, dev, upload=dev.type == "cuda")
        except AssertionError as exc:
            require(False, f"stages feed: {exc}")
    print("[stages] feed reads/s: " + json.dumps({k: round(v["reads_per_s"], 1) for k, v in line["feed"].items()
                                                   if isinstance(v, dict) and "reads_per_s" in v}))

    # One fused quant traced: the untraced run's wall time beside it.
    index = g["indexes"][(31,)][1]
    config = QuantConfig(batch_size=BATCH, max_read_len=256, em_dtype="float64")
    packed = PackedReads(codes, lengths, [])
    quantify(index, packed, config)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = quantify(index, packed, config)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    reset_launches()
    events, wall = traced(lambda: quantify(index, packed, config), dev)
    launches = read_launches()
    for name in results:
        record(results, name, launches_stages=launches[name])
    missing = [k for k in ("K1", "G", "P") if launches[k] < 1]
    require(not missing, f"stages: kernels never launched in the traced quant: {missing}")
    batches = -(-int(lengths.size) // BATCH)
    device_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s, share = busy_share(device_events, wall)
    line["quant"] = {"reads": int(lengths.size), "batches": batches, "untraced_s": untraced, "traced_s": wall,
                     "timing": res.timing, "em_iterations": res.em_iterations,
                     "device_ops": len(device_events), "busy_s": busy_s, "busy_share": share, "idle_share": 1 - share,
                     "top_ops": [{"name": n, "device_ms": ms, "records": c}
                                 for n, ms, c in device_ms_by_name(device_events, 15)],
                     "launches": {k: v for k, v in launches.items() if v},
                     "launches_per_batch": {k: v / batches for k, v in launches.items() if v},
                     "host_ops_per_batch": host_ops(events, batches)}
    require(np.isfinite(res.pi).all() and res.num_mapped > 0.9 * lengths.size, "stages: the traced quant's result")
    q = line["quant"]
    print(f"[stages] fused quant of {q['reads']} reads at k = 31: {untraced:.4f} s untraced, {wall:.4f} s traced; "
          f"{q['device_ops']} device operations, busy {100 * share:.1f}% (idle {100 * (1 - share):.1f}%); "
          f"per batch " + json.dumps({k: round(v, 1) for k, v in q["host_ops_per_batch"].items()})
          + f" (the per-batch route's, PERF.md: launch 89.5, memcpy 2.8, sync 2.4, torch_ops 98.6); "
          f"launches {json.dumps(q['launches'])}")

    # That quant's match stage alone, as _quantify_fused runs it (match_rows
    # on the host codes, then its stats in one read): syncs a call and host
    # operations a batch.  Then a two-group input (half the reads 300
    # bases, padded to 512): the second group's upload follows the first
    # group's queued work, and from pinned memory does not wait for it.
    line["quant"]["match_stage"] = m = match_stage_trace(torch, index, codes, lengths, config, dev)
    print(f"[stages] its match stage: {m['traced_s']:.4f} s traced, {m['syncs']:.0f} synchronizes "
          f"({m['groups']} length group(s); by source {json.dumps(m['sync_sources'])}), per batch "
          + json.dumps({k: round(v, 2) for k, v in m["host_ops_per_batch"].items()})
          + f"; host-to-device copies {json.dumps(m['uploads'])}")
    require(m["host_ops_per_batch"]["torch_ops"] <= 98.6 / 10,
            f"stages: the match stage dispatched {m['host_ops_per_batch']['torch_ops']} torch operations a batch")
    half = lengths.size // 2
    long_codes, long_lengths = sample_reads(g["seqs"], half, 300, 304, seed=73)
    two_codes = np.zeros((2 * half, 304), np.uint8)
    two_codes[:half, : codes.shape[1]], two_codes[half:] = codes[:half], long_codes
    two_lengths = np.concatenate([lengths[:half], long_lengths])
    del long_codes, long_lengths
    line["quant"]["match_stage_two_groups"] = m2 = match_stage_trace(torch, index, two_codes, two_lengths, config, dev)
    print(f"[stages] a two-group match stage ({half} reads of 150 and {half} of 300 bases): {m2['traced_s']:.4f} s "
          f"traced, {m2['syncs']:.0f} synchronizes ({m2['groups']} length groups; by source "
          f"{json.dumps(m2['sync_sources'])}), per batch "
          + json.dumps({k: round(v, 2) for k, v in m2["host_ops_per_batch"].items()})
          + f"; host-to-device copies {json.dumps(m2['uploads'])}")
    require(m2["groups"] == 2, f"stages: the two-group input formed {m2['groups']} length groups")
    line["quant"]["upload_wait_ms"] = w = upload_wait(torch, index, codes, lengths, config, dev)
    print(f"[stages] host ms to issue a length group's upload ({w['reads']} reads) behind {w['queued']:.2f} ms of "
          f"queued device work: through pipeline._groups (pinned) {w['pinned']:.2f}, the same rows from pageable "
          f"memory {w['pageable']:.2f}")
    require(w["pinned"] < w["queued"] / 2,
            f"stages: the group upload waited for the queued device work ({w['pinned']:.2f} of {w['queued']:.2f} ms)")
    for what, stage in (("the match stage", m), ("the two-group match stage", m2)):
        require(stage["syncs"] <= stage["groups"] + 1,
                f"stages: {what} synchronized {stage['syncs']} times over {stage['groups']} length groups")
        pageable = {k: v for k, v in stage["uploads"].items() if "Pageable" in k}
        require(not pageable, f"stages: {what} uploaded from pageable memory: {pageable}")
    del two_codes, two_lengths
    print(f"[stages] {json.dumps(line)}")
    del events, device_events


def match_stage_trace(torch, index, codes, lengths, config, dev) -> dict:
    """A fused quant's match stage alone, as _quantify_fused runs it
    (match_rows on the host codes, then its stats in one read), warmed up
    and then traced: its length groups, synchronizing calls (less an
    empty trace's own: traced() ends in a synchronize, and so may the
    profiler) by the operation they sit under, host operations a batch,
    and the host-to-device copies' device records by kind (Kineto names
    each by its source memory, pinned or pageable)."""
    import collections

    import profile_step_torch

    from sketch_rna_tpu_torch.pipeline import length_groups, match_rows
    from sketch_rna_tpu_torch.utils.profiling import host_ops, traced

    def match_stage():
        _, _, _, stats = match_rows(index, torch.from_numpy(codes), lengths, config)
        return torch.stack(list(stats.values())).tolist()

    match_stage()
    events, wall = traced(match_stage, dev)
    batches = sum(-(-(lengths[rows].size) // config.batch_size) for _, rows in length_groups(lengths, codes.shape[1]))
    syncs = host_ops(events, 1)["sync"] - host_ops(traced(lambda: None, dev)[0], 1)["sync"]
    return {"traced_s": wall, "groups": len(length_groups(lengths, codes.shape[1])), "batches": batches,
            "syncs": syncs, "host_ops_per_batch": host_ops(events, batches),
            "sync_sources": dict(collections.Counter(
                e.cpu_parent.name if e.cpu_parent is not None else "(none)" for e in events
                if e.name in profile_step_torch.SYNC_CALLS)),
            "uploads": dict(collections.Counter(e.name for e in events
                                                if e.device_type == torch.autograd.DeviceType.CUDA
                                                and e.name.startswith("Memcpy HtoD")))}

def upload_wait(torch, index, codes, lengths, config, dev, reads: int = 65536, cycles: int = 200_000_000) -> dict:
    """Host ms to issue the first length group of `reads` host reads
    through pipeline._groups (its cut, pinned staging and upload), and a
    non_blocking upload of the same rows from pageable memory, each behind
    ~0.1 s of queued device work (torch.cuda._sleep), and that work's own
    ms: an upload that waits for the stream to drain takes at least as
    long as the queued work on the host."""
    import numpy as np

    from sketch_rna_tpu_torch.pipeline import _groups

    host, n = torch.from_numpy(codes[:reads]), lengths[:reads]
    l_eff = next(_groups(index, host, n, config))[1]
    pageable = torch.from_numpy(np.ascontiguousarray(codes[:reads, :l_eff]))
    issue = {"queued": lambda: torch.cuda.synchronize(), "pinned": lambda: next(_groups(index, host, n, config)),
             "pageable": lambda: pageable.to(dev, non_blocking=True)}
    out = {"reads": reads}
    for name, fn in issue.items():
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        out[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    return out

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
    events = cuda_events(prof)
    busy_s, share = busy_share(events, wall)
    print(f"[profile] streamed quant of {packed.num_reads} reads: wall {wall:.4f} s traced, stages "
          f"{json.dumps({k: round(v, 4) for k, v in res.timing.items()})}; {len(events)} device operations, "
          f"busy {busy_s * 1e3:.2f} ms: idle {100 * (1 - share):.1f}%")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    print(table)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of {', '.join(PHASES)}; or shared-shapes alone: only the device times of "
                             "the functions both trees share, as JSON (what --parent runs in the other checkout)")
    parser.add_argument("--profile", action="store_true",
                        help="last, trace one steady streamed quant with torch.profiler")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of another commit holding this script: the kernels phase times the "
                             "functions both trees share there too, before and after this tree's "
                             "(parent_shared_ms), with this tree's timing helpers (utils/profiling.py)")
    parser.add_argument("--rank-worker", nargs=5, metavar=("RANK", "WORLD", "PORT", "WORKDIR", "DEVICE"),
                        help="run as one rank process of the sharded phase (what that phase starts)")
    args = parser.parse_args()
    if args.rank_worker:
        rank, world, port, workdir, device_type = args.rank_worker
        return rank_worker(int(rank), int(world), int(port), workdir, device_type)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - {"shared-shapes"})
    if unknown:
        parser.error(f"unknown phases {unknown}")
    if "shared-shapes" in phases and phases != ["shared-shapes"]:
        parser.error("shared-shapes runs alone")

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
    if phases == ["shared-shapes"]:  # what --parent asks of another checkout
        from sketch_rna_tpu_torch import kernels

        kernels.library()
        print(json.dumps({"shared_ms": shared_times(torch, {})}))
        return 0
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    results = {name: {"name": fn, "route": "cuda", "source": src, "replaces": rep}
               for name, (fn, src, rep) in KERNELS.items()}
    ctx = {}  # data that several phases share (the c3 index and reads)
    runs = {
        "kernels": lambda: phase_kernels(torch, results, ctx, args.parent.resolve() if args.parent else None),
        "group": lambda: phase_group(torch, results),
        "merge": lambda: phase_merge(torch, results),
        "probe-segsum": lambda: phase_probe_segsum(torch, results, ctx),
        "sample": phase_sample,
        "sample-multik": phase_sample_multik,
        "scale": lambda: phase_scale(torch, results, ctx),
        "scale-multik": lambda: phase_scale_multik(torch, results, ctx),
        "crosscheck": lambda: phase_crosscheck(torch, ctx),
        "fuzz": lambda: phase_fuzz(torch, results, smi),
        "spill": lambda: phase_spill(torch, results),
        "long-reads": lambda: phase_long_reads(torch, results),
        "stream": lambda: phase_stream(torch, ctx),
        "sharded": lambda: phase_sharded(torch, results, ctx, smi),
        "stream-c3": lambda: phase_stream_c3(torch, ctx),
        "cli-stream": lambda: phase_cli_stream(torch, ctx),
        "gencode": lambda: phase_gencode(torch, results, ctx),
        "graph-store": lambda: phase_graph_store(torch, ctx),
        "stages": lambda: phase_stages(torch, results, ctx, smi),
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
