#!/usr/bin/env python3
"""Drive the PyTorch port (sketch_rna_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py                    # from the repository root; needs one card
    python3 chip_smoke.py --phases kernels   # a subset (device and build always run)
    python3 chip_smoke.py --phases kernels --parent DIR   # + DIR's shared functions timed beside these
    python3 chip_smoke.py --phases shared-shapes         # only the shared functions' times, as JSON

Phases, in order; any failure raises and the script exits nonzero
without printing its result line:

  device        torch / CUDA versions, the card's name and power limit;
  build         nvcc builds the kernels in csrc/, one process per source;
  kernels       K1 (fused sketch), K2 (multi-k fused sketch), K3 (kept
                windows), K4 (row sort, int32), K4-int64 and the merge
                kernel against their plain PyTorch versions on the card,
                bit for bit, over the edges of their domains (K1 / K2 at
                104, 152 and 1028 bases, fractions 0.05 and 0.9999, caps
                that overflow; K3 at [8192, 2048] and [8191, 2001] at an
                offset and one 4-megabase index-build row, also at an odd
                offset, fractions 0.05 and 0.9999; K4 at every width 2 ..
                16384 and 8192, 8191 or 1 rows; the merge at row widths 2
                .. 65536, row_sort_wide and an int32 sort_event_parts);
                then each kernel's device time at its main-path shape
                beside its plain version's, torch.sort's for K4 and the
                merge, and its bound, and K4 against torch.sort at every
                width; then the functions both trees share (K3's call,
                sketch_reads of 2 kb and 20 kb reads, row_sort_wide), with
                --parent also in DIR.  Device time is torch.profiler's, per
                kernel launch or per whole call, over 50 calls whose inputs
                rotate through copies past the L2 cache, timed in turns
                plain, kernel, kernel, plain; the host is left out;
  sample        the port's CLI on examples/sample.{fa,fq}, k=31: the CSV of
                a plain quant (default flags: float64 EM) and of --em-dtype
                float64 is byte-identical to examples/sample.expected.csv,
                the float32 CSV within 1e-4 relative;
  sample-multik the CLI with -k 21,31, float64, on the card and in-process
                with --device cpu: same rows, values within 1e-9 relative;
  scale         6,000 synthetic isoform-family transcripts + 1,000,000
                reads of 100 bp, k=31, batch 8192, float32 EM;
  scale-multik  the c3_chr20_multik configuration: 20,000 transcripts
                (synth_transcriptome, seed 22) + 2,097,152 reads of 100 bp,
                k=(21, 31), batch 8192, float32 EM;
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
                device time at the gathered shapes beside its bound.  Then
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

Then one JSON line per kernel ({"kernels": [...]}: launches on the main
path, device ms, plain ms, bound in ms and us with the bytes and
operations behind it, share of bound, library_ms (torch.sort for K4 and
the merge), the shared functions' ms and, with --parent, the parent's),
the nvidia-smi line of the card, and last {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import argparse
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
REPS = 50  # calls per device-time measurement
L2_BYTES = 50 * 2**20
# The H100 SXM's published memory rate; its CUDA cores' 32-bit integer
# rate (132 SMs x 64 lanes x 1.98 GHz boost), which the published table of
# peaks leaves out.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
PHASES = ("kernels", "sample", "sample-multik", "scale", "scale-multik", "spill", "long-reads", "stream", "sharded",
          "stream-c3", "cli-stream", "samples")
# The sharded phase's rank processes: (world size, meshes run in that world).
SHARDED_WORLDS = ((2, ((1, 2), (2, 1))), (4, ((2, 2),)))
RANK_JOIN_S = 420  # a world of rank processes is killed after this long
KERNELS = {
    "K1": ("fused_sketch", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:160"),
    "K2": ("fused_sketch_multik", "sketch_rna_tpu_torch/csrc/sketch.cu", "sketch_rna_tpu/hash/pallas_hash.py:266"),
    "K3": ("nthash_sketch", "sketch_rna_tpu_torch/csrc/hash.cu", "sketch_rna_tpu/hash/pallas_hash.py:46"),
    "K4": ("row_sort", "sketch_rna_tpu_torch/csrc/row_sort.cu", "sketch_rna_tpu/match/pallas_sort.py:49"),
    "K4-int64": ("row_sort (int64 keys)", "sketch_rna_tpu_torch/csrc/row_sort.cu",
                 "sketch_rna_tpu/match/pallas_sort.py:49"),
    # No TPU kernel merges: the JAX package's bitonic merge of sorted parts runs in XLA.
    "merge": ("merge_pairs", "sketch_rna_tpu_torch/csrc/merge.cu", "sketch_rna_tpu/match/rowmatch.py:122"),
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


MARK = "spin_kernel"  # torch.cuda._sleep's kernel, which marks where a call starts


def whole_calls(events):
    """The device operations of each call that a trace holds whole: the
    runs between consecutive marks whose length is the most common one.
    A lost record shortens its call's run and a lost mark merges two
    runs; either way that run is left out."""
    runs, cur = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if MARK in e.name:
            if cur is not None:
                runs.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    if not runs:
        return []
    lengths = [len(r) for r in runs]
    n = max(set(lengths), key=lengths.count)
    return [r for r in runs if len(r) == n]


def device_ms(torch, fn, arg_sets, kernel=None, reps=None):
    """Mean device time of one call of fn(*args), in ms: torch.profiler
    over `reps` calls after a warm-up, cycling through arg_sets.  With
    `kernel` (a substring of a kernel's name) the mean time of that
    kernel's traced launches; else the mean, over the calls the trace
    holds whole (whole_calls), of the sum of each call's device
    operations.  The host's share of a call is left out.

    A trace on the card can lose some of its device records (3 of 50,
    now and then, in one run).  So a trace is taken again until it holds
    every launch or every call whole, at most four times, keeping the
    fullest, which must hold half of them."""
    from torch.profiler import ProfilerActivity, profile

    if reps is None:
        reps = REPS
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    best, counts = [], []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                if kernel is None:
                    torch.cuda._sleep(0)
                fn(*arg_sets[r % len(arg_sets)])
            if kernel is None:
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in events if kernel in e.name] if kernel is not None else whole_calls(events)
        counts.append(len(mine))
        if len(mine) > len(best):
            best = mine
        if len(mine) == reps:
            break
    if len(set(counts)) > 1:
        print(f"[kernels] traces of {kernel or 'a call'} held {counts} {'launches' if kernel else 'whole calls'} "
              f"of {reps}; the fullest is used")
    require((reps + 1) // 2 <= len(best) <= reps,
            f"{len(best)} {'launches of ' + kernel if kernel else 'whole calls'} traced in {reps} calls")
    if kernel is not None:
        return sum(e.time_range.elapsed_us() for e in best) / len(best) / 1e3
    return sum(e.time_range.elapsed_us() for run in best for e in run) / len(best) / 1e3


def in_turns(torch, kernel_fn, plain_fn, arg_sets, kernel, reps=None):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = device_ms(torch, plain_fn, arg_sets, reps=reps)
    k1 = device_ms(torch, kernel_fn, arg_sets, kernel, reps)
    k2 = device_ms(torch, kernel_fn, arg_sets, kernel, reps)
    p2 = device_ms(torch, plain_fn, arg_sets, reps=reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: int, ops: int):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the integer operations over the integer rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def sort_work(B: int, W: int, itemsize: int):
    """(bytes, integer operations) of sorting [B, W] keys: each row read
    and written once; the ceil(log2 W!) comparisons a comparison sort of
    a row needs at least, one operation each on 32-bit words (two on
    int64), whatever network a kernel runs."""
    need = math.ceil(math.lgamma(W + 1) / math.log(2))
    return 2 * B * W * itemsize, B * need * (itemsize // 4)


def sketch_work(B: int, L: int, ks, caps):
    """(bytes, integer operations) of sketching [B, L] reads at ks: codes
    and lengths in, per k a [B, cap] int64 row + bool mask + int32
    overflow out; ~8 operations per position (the prefix XOR) and per
    window (its hash and threshold)."""
    nbytes = B * L + 4 * B + sum(B * cap * 9 + 4 * B for cap in caps)
    return nbytes, 8 * B * L + sum(8 * B * (L - k + 1) for k in ks)


def kept_work(B: int, L: int, k: int, m: int):
    """(bytes, integer operations) of K3 over [B, L] reads at k with an
    output width of m: codes and lengths in, [B, m] int64 hashes, [B, m]
    int32 windows and [B] int32 counts out; ~8 operations per position
    (the prefix XOR) and per window (its hash, threshold and ballot)."""
    return B * L + 4 * B + 12 * B * m + 4 * B, 8 * B * L + 8 * B * (L - k + 1)


def merge_work(N: int, W: int, itemsize: int):
    """(bytes, integer operations) of merging the halves of [N, W] rows:
    each key read and written once; one comparison per output, one
    operation on 32-bit words (two on int64)."""
    return 2 * N * W * itemsize, N * W * (itemsize // 4)


def counters():
    """Each kernel wrapper's launch count (name -> (object, attribute))."""
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match.row_sort import merge_pairs, row_sort

    return {"K1": (fused_sketch, "launches"), "K2": (fused_sketch_multik, "launches"),
            "K3": (nthash_sketch, "launches"), "K4": (row_sort, "launches"),
            "K4-int64": (row_sort, "launches_i64"), "merge": (merge_pairs, "launches")}


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
    (PERF.md §6), K3 on long reads, the merge on every batch of the
    sharded route ("merge-wide": its round inside row_sort_wide)."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
    from sketch_rna_tpu_torch.match.row_sort import bitonic_merge_pair, merge_pairs, row_sort, row_sort_plain
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_kept, sketch_all_k, sketch_batch

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
    # The merge: the sharded route's round over a c3 batch's two 128-lane
    # parts (every batch, PERF.md §6), and row_sort_wide's round.
    for name, w, dtype, what in (("merge", 128, torch.int32, "the sharded route's round on c3"),
                                 ("merge-wide", 1 << 14, torch.int64, "row_sort_wide's round")):
        x = _halves(torch, _keys(torch, gen, BATCH, 2 * w, dtype), w)
        cases[name] = (merge_pairs, lambda x, w=w: bitonic_merge_pair(x[:, :w], x[:, w:]), "merge_kernel", (x,),
                       merge_work(BATCH, 2 * w, x.element_size()), f"[{BATCH}, {2 * w}] {str(dtype)[6:]} ({what})")
    return {name: (fn, plain, kern, rotation(args, sum(a.numel() * a.element_size() for a in args)), work, shape)
            for name, (fn, plain, kern, args, work, shape) in cases.items()}


def shared_cases(torch):
    """Functions that take one signature in this tree and in its parent, at
    the long-read shapes, inputs made from SEED: name -> (callable,
    argument copies, calls per trace).  Each is timed per whole call."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
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
    return cases


def shared_times(torch):
    """shared_cases' device ms per whole call, two traces each: what the
    shared-shapes phase prints for a comparison run."""
    return {name: (device_ms(torch, fn, args, reps=reps) + device_ms(torch, fn, args, reps=reps)) / 2
            for name, (fn, args, reps) in shared_cases(torch).items()}


def parent_times(torch, parent: Path):
    """shared_times of `parent`, a checkout of another commit holding this
    script, in a process of its own on this card."""
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, str(parent / "chip_smoke.py"), "--phases", "shared-shapes"], cwd=parent,
                         capture_output=True, text=True, timeout=600)
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


def phase_kernels(torch, results, parent=None):
    """Every kernel against its plain version, bit for bit, at the edges
    of its domain; then device times (the host left out) at the main-path
    shapes and, for K4, at every width beside torch.sort; then the
    functions both trees share, with --parent also in the parent."""
    import numpy as np

    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
    from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik, window_pad
    from sketch_rna_tpu_torch.match.row_sort import (bitonic_merge_pair, merge_pairs, row_sort, row_sort_plain,
                                                     row_sort_wide)
    from sketch_rna_tpu_torch.match.rowmatch import I32_MAX, sort_event_parts
    from sketch_rna_tpu_torch.sketch.fracminhash import hash_kept, sketch_all_k, sketch_batch

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
    # The merge kernel against bitonic_merge_pair at every row width 2 ..
    # 65536 (one row, B rows, B - 1 rows from an odd address; B shrinks
    # past 8192 lanes); row_sort_wide and sort_event_parts against torch.sort.
    for dtype in (torch.int32, torch.int64):
        for W in (1 << e for e in range(1, 17)):
            B = BATCH if W <= 1 << 13 else (1 << 26) // W
            x = _halves(torch, _keys(torch, gen, B, W, dtype), W // 2)
            for rows in (x, x[:1], _odd_offset(torch, x[1:])):
                got = merge_pairs(rows)
                require(torch.equal(got, bitonic_merge_pair(rows[:, : W // 2], rows[:, W // 2 :])),
                        f"merge_pairs differs from bitonic_merge_pair at [{rows.shape[0]}, {W}] {dtype}")
            del x, rows, got
        print(f"[kernels] merge {str(dtype)[6:]} [B, W], W = 2 .. 65536, one row, B rows and B - 1 from an odd "
              "address: bit-equal")
    record(results, "merge", max_abs_err=0)
    for widths in ((512, 300), (256, 130, 256)):
        parts = [_keys(torch, gen, BATCH, w, torch.int32) for w in widths]
        span = (1 << (len(widths) - 1).bit_length()) * max(widths)
        fill = torch.full((BATCH, span - sum(widths)), I32_MAX, dtype=torch.int32, device=DEVICE)
        got = sort_event_parts(parts)
        require(torch.equal(got, row_sort_plain(torch.cat(parts + [fill], dim=1))),
                f"sort_event_parts differs from torch.sort at part widths {widths}")
        print(f"[kernels] sort_event_parts int32 [{BATCH}] x part widths {widths} -> [{BATCH}, {span}]: "
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
        print(f"[kernels] row_sort_wide int64 [{B}, {W}]: bit-equal; device ms per call: {ms:.4f} (K4-int64 chunks "
              f"+ {int(math.log2(W >> 14))} merge launches), torch.sort {sort_ms:.4f}")
        del x
    record(results, "merge", row_sort_wide=wide)

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
        elif name.startswith("merge"):
            library_ms = device_ms(torch, row_sort_plain, arg_sets, reps=reps)
        timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, bound_us=b_ms * 1e3,
                     bound_share=b_ms / ms, bound_bytes=nbytes, bound_ops=ops, library_ms=library_ms, shape=shape,
                     timed="per call" if kern is None else "per launch")
        if name == "merge-wide":
            record(results, "merge", wide_round=timed)
        else:
            record(results, name, **timed)
        print(f"[kernels] {name} {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              + (f"torch.sort {library_ms:.5f} ms, " if library_ms is not None else "")
              + f"bound {b_ms * 1e3:.3f} us ({by}: {nbytes} bytes, {ops} operations), {100 * b_ms / ms:.1f}% of bound")
        if name == "K3":  # its two passes, per launch
            passes = {p: device_ms(torch, fn, arg_sets, f"hash_kept_kernel<{w}>") for p, w in
                      (("count_pass_ms", "false"), ("write_pass_ms", "true"))}
            record(results, name, **passes)
            print(f"[kernels] K3 passes, device ms per launch: count {passes['count_pass_ms']:.5f}, "
                  f"write {passes['write_pass_ms']:.5f}")
    del cases

    # The functions both trees share, per whole call; with --parent, the
    # parent's before and after this tree's.
    p1 = parent_times(torch, parent) if parent else None
    mine = shared_times(torch)
    p2 = parent_times(torch, parent) if parent else None
    for name, ms in mine.items():
        owner = results["merge" if name.startswith("row_sort_wide") else "K3"]
        owner.setdefault("shared_ms", {})[name] = ms
        line = f"[kernels] {name}: device ms per call {ms:.5f}"
        if parent:
            owner.setdefault("parent_shared_ms", {})[name] = (p1[name] + p2[name]) / 2
            line += f"; parent ({parent.name}) {p1[name]:.5f} / {p2[name]:.5f}"
        print(line)


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
        expected = (ex / "sample.expected.csv").read_bytes()
        require(Path(out).read_bytes() == expected,
                "the CSV of a quant with default flags is not byte-identical to sample.expected.csv")
        require(Path(out64).read_bytes() == expected, "float64 CSV is not byte-identical to sample.expected.csv")
        a, b = _csv_rows(out32), _csv_rows(ex / "sample.expected.csv")
        require(a.keys() == b.keys(), "float32 CSV has another row set")
        rel = max(abs(x - y) / max(abs(y), 1e-9) for n in a for x, y in zip(a[n], b[n]))
        require(rel < 1e-4, f"float32 CSV max relative difference {rel}")
    print(f"[sample] default-flags CSV and float64 CSV byte-identical ({len(b)} rows); float32 max relative diff "
          f"{rel:.3g}")


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
    k1 = in_turns(torch, lambda c, n: fused_sketch(c, n, 31, f, cap), lambda c, n: sketch_batch(c, n, 31, f, cap),
                  rotation((c, n), c.numel() + 4 * n.numel()), "sketch")
    k4 = in_turns(torch, row_sort, row_sort_plain, rotation((key,), 4 * key.numel()), "row_sort_kernel")
    print(f"[scale] first batch, device ms: K1 [{BATCH}, {L}] cap {cap}: kernel {k1[0]:.5f}, plain {k1[1]:.5f}; "
          f"K4 [{BATCH}, {key.shape[1]}]: kernel {k4[0]:.5f}, plain {k4[1]:.5f}")
    record(results, "K1", launches=launches["K1"])


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
    record(results, "K4", launches=launches["K4"])
    record(results, "K4-int64", launches=launches["K4-int64"])


def phase_spill(torch, results):
    """Per-k table spill on the card: the batch regroups merged, equal to a
    forced merged run; the regroup's sort_event_parts runs the merge kernel."""
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
    f = config.sketch_fraction
    widths = _dedup_widths(c, n, (31,), f, caps)
    require(0 < max(widths) <= 256, f"the 2,000 bp dedup sorted at widths {widths}, not at most 256 lanes")
    k3 = in_turns(torch, lambda c, n: nthash_sketch(c, n, 31, f), lambda c, n: hash_kept(c, n, 31, f),
                  rotation((c, n), c.numel() + 4 * n.numel()), None)
    print(f"[long-reads] first batch: dedup sort widths {widths}; device ms per call: K3 [{BATCH}, {L}] k=31: "
          f"kernel {k3[0]:.5f}, plain {k3[1]:.5f}")
    record(results, "K3", launches=launches["K3"])
    del c, n

    # 20 kb reads (nk_pad 32768): their ~1,000 kept hashes a read sort on
    # K4-int64 alone, never through row_sort_wide's merges.
    n_tx, n_reads, read_len = VERY_LONG
    seqs = synth_transcriptome(np.random.default_rng(SEED + 2), n_tx, read_len, read_len + 4000)
    index = to_device(build_index(_records(seqs, "V"), config, device=DEVICE), DEVICE)
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
    t0 = time.perf_counter()
    fused = ctx["c3_fused64"] = quantify(c3["index"], packed, config)
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
    from sketch_rna_tpu_torch.match.row_sort import bitonic_merge_pair, merge_pairs
    from sketch_rna_tpu_torch.pipeline import quantify, quantify_sharded

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
    record(results, "merge", launches=launches["merge"])
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
                            and per_batch["merge"] == len(info["merge_shapes"]) >= 1,
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
                    ms, plain_ms = in_turns(torch, merge_pairs, plain, rotation((x,), nbytes // 2), "merge_kernel")
                    b_ms, by = bound(nbytes, ops)
                    timed[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
                    print(f"[sharded] merge [{rows}, {width}] {dtype_name} (a gathered batch's round): kernel "
                          f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({by}), "
                          f"{100 * b_ms / ms:.1f}% of bound")
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
                             "(parent_shared_ms)")
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
        print(json.dumps({"shared_ms": shared_times(torch)}))
        return 0
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    results = {name: {"name": fn, "route": "cuda", "source": src, "replaces": rep}
               for name, (fn, src, rep) in KERNELS.items()}
    ctx = {}  # data that several phases share (the c3 index and reads)
    runs = {
        "kernels": lambda: phase_kernels(torch, results, args.parent.resolve() if args.parent else None),
        "sample": phase_sample,
        "sample-multik": phase_sample_multik,
        "scale": lambda: phase_scale(torch, results),
        "scale-multik": lambda: phase_scale_multik(torch, results, ctx),
        "spill": lambda: phase_spill(torch, results),
        "long-reads": lambda: phase_long_reads(torch, results),
        "stream": lambda: phase_stream(torch, ctx),
        "sharded": lambda: phase_sharded(torch, results, ctx, smi),
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
