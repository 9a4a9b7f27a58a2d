"""Benchmark of the PyTorch port (sketch_rna_tpu_torch): quant throughput
(reads/s) on one GPU.  The counterpart of the JAX package's bench.py,
with its modes, workloads, sizes and seeds; imports no JAX.

    python3 bench_torch.py                        # the standard bench: one JSON line
    python3 bench_torch.py --configs              # BASELINE configs c0-c5, into --out
    python3 bench_torch.py --configs-full         # the same + the 250k-isoform GENCODE-scale entries
    python3 bench_torch.py --stream32m            # the 32M-read FASTQ entry alone, in a fresh process
    python3 bench_torch.py --standard-spread 10   # the standard bench in 10 fresh processes
    python3 bench_torch.py ... --device cpu       # on the CPU (every kernel's plain version)

Standard bench: 2,000 synthetic isoform-family transcripts (600-2,500
bp, seed 1234), 131,072 reads of 150 bp, batch 8192, k = 31, float32 EM;
one warm-up quant, then the best of 5 timed quants, each ended by a
device synchronize; then one more quant whose stage times and work
counts (QuantResult.timing / sizes) give the roofline
(sketch_rna_tpu_torch/utils/roofline.py).  The port's stage timing
already waits for the device at each stage's end (the match stage reads
its stats on the host, the classes stage synchronizes, the EM copies
its result out), so that run needs no switch.  Prints

    {"metric": "quant_reads_per_s", "value": ..., "unit": "reads/s",
     "roofline": ..., "device": {"name": ..., "power_limit": ...}}

with the card's name and power limit as nvidia-smi prints them.  No
vs_baseline: bench.py's denominator is a TPU target.

--configs runs BASELINE.json's configurations as bench.py does: c0 the
250,000-transcript index build (seed 2026) on the device; c1 the bundled
sample against the port's NumPy oracle (sketch_rna_tpu_torch/oracle/);
c2 6,000 transcripts x 2^20 reads of 100 bp, k = 31, seed 21; c3 20,000
x 2^21 x 100 bp, k = (21, 31), seed 22; c4 50,000 x 2^22 x 150 bp, k =
31, seed 23, through the streamed engine in chunks of 2^20 (forced with
pipeline.FUSED_MAX_PADDED_READS = 0); c5 4 samples x 2^18 reads through
quantify_samples.  --configs-full adds, before c5, the GENCODE-scale
entries on synth_transcriptome(default_rng(2026), 250000) (298.5
Mbases): 2^20 reads of 150 bp (seed 7, padded to 256) at k = 31 and at
k = (21, 31), and the 32M-read FASTQ through LazyScanFeed and
quantify_streamed.  Those read their indexes from the cache that
scripts/scale_check_torch.py writes (--cache-dir) and the FASTQ that
scripts/make_fastq_torch.py writes (--fastq); an entry whose input is
missing, or whose cached index is not bit-equal to the JAX package's
build (utils/synth.py GENCODE_INDEX), says "skipped" and why.  Results merge into --out
(build/bench_torch/matrix.json by default), each entry with the card's
name and power limit.

Differences from bench.py: reads come from utils/synth.py sample_reads
(numpy, the same seeds), not bench.py's jax.random draws, so the reads
differ while the transcriptomes and indexes are the same; indexes are
built on the device each run (seconds) instead of cached across runs,
but for the GENCODE-scale cache; dropped are vs_baseline,
vs_cpp_reference_52s (another machine's time), the XLA compile cache and
link settling (TPU-only), and the comparison against the reference
binary's CSV, whose source is not in the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_TRANSCRIPTS = 2000
TRANSCRIPT_LEN = (600, 2500)
N_READS = 131072
READ_LEN = 150
BATCH = 8192
SEED = 1234
OUT_DIR = ROOT / "build" / "bench_torch"
SCALE_CACHE = OUT_DIR / "scale_cache"
BIG_FASTQ = OUT_DIR / "big32m.fq"
METRIC = "quant_reads_per_s"
# Stats that count work done, not work lost: left out of "overflows".
COUNT_STATS = ("candidate_spilled_per_k", "stream_drains", "stream_compactions", "stream_classes")


def resolve_device(device="cuda"):
    """The torch device to run on: the card unless the caller asks for the
    CPU.  Raises when a card is asked for and there is none."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; pass --device cpu to run on the CPU")
    return dev


def card(device) -> dict:
    """The card's name and power limit as nvidia-smi prints them ("cpu"
    and None on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        name, limit = (part.strip() for part in out.strip().splitlines()[device.index or 0].split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        import torch

        return {"name": torch.cuda.get_device_name(device), "power_limit": None}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Problem(NamedTuple):
    config: object  # QuantConfig
    artifact: object  # IndexArtifact, on the host
    index: object  # DeviceIndex
    packed: object  # PackedReads
    seqs: List[np.ndarray]
    index_s: float  # build + upload seconds


def _problem(seqs, names_width, n_reads, read_len, ks, seed, device, batch=BATCH) -> Problem:
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import fasta_records, sample_reads

    config = QuantConfig(kmer_lengths=tuple(ks), batch_size=batch, max_read_len=((read_len + 127) // 128) * 128,
                         em_dtype="float32")
    t0 = time.perf_counter()
    artifact = build_index(fasta_records(seqs, width=names_width), config, device=device)
    index = to_device(artifact, device)
    index_s = time.perf_counter() - t0
    codes, lengths = sample_reads(seqs, n_reads, read_len, config.max_read_len, seed)
    return Problem(config, artifact, index, PackedReads(codes, lengths, []), seqs, index_s)


def standard_problem(device, n_transcripts: int = N_TRANSCRIPTS, n_reads: int = N_READS) -> Problem:
    """bench.py's build_problem: the standard bench's workload."""
    from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

    seqs = synth_transcriptome(np.random.default_rng(SEED), n_transcripts, *TRANSCRIPT_LEN)
    return _problem(seqs, 5, n_reads, READ_LEN, (31,), SEED, device)


def synth_problem(n_transcripts: int, n_reads: int, read_len: int, ks, seed: int, device, batch=BATCH) -> Problem:
    """bench.py's _synth_problem: synth_transcriptome(default_rng(seed),
    n_transcripts), its index at ks on `device`, n_reads reads of
    read_len bases drawn from `seed`, float32 EM."""
    from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

    seqs = synth_transcriptome(np.random.default_rng(seed), n_transcripts)
    return _problem(seqs, 6, n_reads, read_len, ks, seed, device, batch)


def c5_samples(problem: Problem, n_reads: int, read_len: int = 100, seed: int = 24) -> dict:
    """c5's four samples: the problem's reads, then fresh draws from
    seeds seed + 1 .. seed + 3 (bench.py's _resample)."""
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import sample_reads

    samples = {"s0": problem.packed}
    for i in range(1, 4):
        codes, lengths = sample_reads(problem.seqs, n_reads, read_len, problem.config.max_read_len, seed + i)
        samples[f"s{i}"] = PackedReads(codes, lengths, [])
    return samples


def overflows(stats: dict) -> dict:
    """The nonzero loss stats of a quant (bench.py's "overflows")."""
    return {k: v for k, v in stats.items() if v and k not in COUNT_STATS}


def timed_quant(problem: Problem, device, repeats: int = 2) -> dict:
    """bench.py's _timed_quant: a warm-up quant, the best of `repeats`
    timed ones (each ended by a synchronize), then one more whose stage
    times give the EM's rate and, for a fused quant, the roofline."""
    from sketch_rna_tpu_torch.pipeline import quantify
    from sketch_rna_tpu_torch.utils.roofline import roofline

    cfg, index, packed = problem.config, problem.index, problem.packed
    quantify(index, packed, cfg)
    sync(device)
    best, result = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        r = quantify(index, packed, cfg)
        sync(device)
        dt = time.perf_counter() - t0
        if dt < best:
            best, result = dt, r
    rs = quantify(index, packed, cfg)
    em_time = rs.timing.get("em_assign", 0.0)
    out = {
        "reads_per_s": round(packed.num_reads / best, 1),
        "elapsed_s": round(best, 3),
        "em_iterations": result.em_iterations,
        "em_iters_per_s": round(result.em_iterations / em_time, 1) if em_time else None,
        "overflows": overflows(result.stats),
    }
    if "stream_classes" in result.stats:
        out["stream_classes"] = result.stats["stream_classes"]
    if rs.sizes:
        out["roofline"] = roofline(rs.sizes, rs.timing, best, rs.em_iterations, 8 if cfg.em_dtype == "float64" else 4)
    return out


def run_standard(device="cuda", n_transcripts: int = N_TRANSCRIPTS, n_reads: int = N_READS,
                 repeats: int = 5) -> dict:
    """The standard bench; prints and returns its JSON line."""
    device = resolve_device(device)
    p = standard_problem(device, n_transcripts, n_reads)
    t = timed_quant(p, device, repeats)
    line = {"metric": METRIC, "value": t["reads_per_s"], "unit": "reads/s", "roofline": t["roofline"],
            "device": card(device)}
    print(json.dumps(line), flush=True)
    print(f"[bench] T={p.index.num_transcripts} reads={p.packed.num_reads} elapsed={t['elapsed_s']}s "
          f"em_iters={t['em_iterations']} index_build={p.index_s:.2f}s", file=sys.stderr)
    return line


def _load_matrix(out: Path) -> dict:
    if out.exists():
        with open(out) as fh:
            return json.load(fh)
    return {}


def _save_matrix(out: Path, table: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(table, fh, indent=1)


def _put(table: dict, name: str, entry: dict, card_info: dict) -> None:
    table[name] = {**entry, "card": card_info}
    print(json.dumps({"config": name, **table[name]}), file=sys.stderr, flush=True)


def load_gencode_index(path: Path, ks):
    """(the cached GENCODE-scale index at `path`, None), or (None, why it
    cannot be timed): missing, or some k not bit-equal to the JAX
    package's build (utils/synth.py GENCODE_INDEX), as a cache built at
    another sketch fraction or by other code would be."""
    from sketch_rna_tpu_torch.index.artifact import load_index
    from sketch_rna_tpu_torch.utils.synth import GENCODE_INDEX

    if not Path(path).exists():
        return None, (f"missing {path} (run scripts/scale_check_torch.py --transcripts 250000 "
                      f"--k {','.join(map(str, ks))})")
    artifact = load_index(str(path))
    for k in ks:
        ki = artifact.per_k.get(k)
        got = None if ki is None else (ki.num_keys, int(ki.postings.size), ki.sha256())
        if got != GENCODE_INDEX[k]:
            return None, (f"{path} at k={k} is not the GENCODE-scale index (keys, postings, sha256 {got}, "
                          f"want {GENCODE_INDEX[k]}); delete it and rerun scripts/scale_check_torch.py")
    return artifact, None


def cached_index(n_transcripts: int, ks, device, cache_dir: Path = SCALE_CACHE):
    """(the index artifact of gencode_transcriptome(n_transcripts) at ks,
    that transcriptome, where the index came from): read from cache_dir's
    T<N>_k<ks>.npz (at the GENCODE scale only if it equals the JAX
    package's build, load_gencode_index), else built on `device` and
    saved there."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import load_index, save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import GENCODE_TRANSCRIPTS, fasta_records, gencode_transcriptome

    seqs = gencode_transcriptome(n_transcripts)
    path = Path(cache_dir) / f"T{n_transcripts}_k{'_'.join(map(str, ks))}.npz"
    if path.exists():
        if n_transcripts != GENCODE_TRANSCRIPTS:
            return load_index(str(path)), seqs, f"index loaded from cache {path}"
        artifact, why = load_gencode_index(path, ks)
        if artifact is not None:
            return artifact, seqs, f"index loaded from cache {path}"
        print(f"not using the cache: {why}", file=sys.stderr)
    t0 = time.perf_counter()
    artifact = build_index(fasta_records(seqs), QuantConfig(kmer_lengths=tuple(ks)), device=device)
    built = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    save_index(str(path), artifact)
    return artifact, seqs, f"index built on {device} in {built:.1f}s"


def config0_index_build(device) -> dict:
    """c0: the GENCODE-scale index build (k = 31) on the device, timed
    from the records to the host arrays."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import fasta_records, gencode_transcriptome

    seqs = gencode_transcriptome()
    recs = fasta_records(seqs)
    mbases = sum(s.size for s in seqs) / 1e6
    t0 = time.perf_counter()
    idx = build_index(recs, QuantConfig(kmer_lengths=(31,)), device=device)
    dt = time.perf_counter() - t0
    return {"transcripts": idx.num_transcripts, "mbases": round(mbases, 1), "elapsed_s": round(dt, 1),
            "mbases_per_s": round(mbases / dt, 1), "keys": idx.per_k[31].num_keys,
            "postings": int(idx.per_k[31].postings.size)}


def config1_sample_data(device) -> dict:
    """c1: the bundled sample against the NumPy oracle (the reference's
    semantics): EM abundance and NumReads max-abs-diff, rank order."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import load_fasta
    from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
    from sketch_rna_tpu_torch.io.packing import encode_sequence, pack_reads
    from sketch_rna_tpu_torch.oracle import oracle_quant
    from sketch_rna_tpu_torch.pipeline import quantify

    recs = load_fasta(str(ROOT / "examples" / "sample.fa"))
    cfg = QuantConfig(kmer_lengths=(31,), batch_size=1024, max_read_len=128, em_dtype="float64")
    idx = to_device(build_index(recs, cfg, device=device), device)
    reads = load_fastq_dict(str(ROOT / "examples" / "sample.fq"), min_len=31)
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=31, pad_len=128)
    t0 = time.perf_counter()
    result = quantify(idx, packed, cfg)
    dt = time.perf_counter() - t0
    _, o_pi, o_w, o_tids = oracle_quant([encode_sequence(s) for s in recs.seqs],
                                        {rid: encode_sequence(sq) for rid, sq in reads.items()}, (31,))
    rank_ours = np.argsort(-result.pi, kind="stable")
    rank_oracle = np.argsort(-np.asarray(o_pi), kind="stable")
    return {"reads_per_s": round(packed.num_reads / dt, 1), "em_dtype": cfg.em_dtype,
            "abundance_max_abs_diff_vs_ref": float(np.max(np.abs(result.pi - o_pi))),
            "numreads_max_abs_diff_vs_ref": float(np.max(np.abs(result.weighted_counts - o_w))),
            "rank_identical": bool((rank_ours == rank_oracle).all()), "csv_rows": int(result.has_entry.sum()),
            "oracle_rows": len(o_tids)}


@contextlib.contextmanager
def forced_streaming():
    """Routes every quantify through the streamed engine, as bench.py
    forces it (pipeline.FUSED_MAX_PADDED_READS = 0)."""
    from sketch_rna_tpu_torch import pipeline

    saved = pipeline.FUSED_MAX_PADDED_READS
    pipeline.FUSED_MAX_PADDED_READS = 0
    try:
        yield
    finally:
        pipeline.FUSED_MAX_PADDED_READS = saved


def config5_multisample(device, n_reads: int = 1 << 18) -> dict:
    """c5: four samples of n_reads over one index (6,000 transcripts,
    seed 24) through quantify_samples, after a one-sample warm-up."""
    from sketch_rna_tpu_torch.pipeline import quantify_samples

    p = synth_problem(6000, n_reads, 100, (31,), 24, device)
    samples = c5_samples(p, n_reads)
    quantify_samples(p.index, {"warm": p.packed}, p.config)
    sync(device)
    t0 = time.perf_counter()
    quantify_samples(p.index, samples, p.config)
    sync(device)
    dt = time.perf_counter() - t0
    n_total = sum(s.num_reads for s in samples.values())
    return {"samples": len(samples), "reads_per_s": round(n_total / dt, 1), "elapsed_s": round(dt, 3)}


def run_configs(device="cuda", full: bool = False, out: Path = OUT_DIR / "matrix.json",
                cache_dir: Path = SCALE_CACHE, fastq: Path = BIG_FASTQ) -> dict:
    """BASELINE.json's configuration matrix (bench.py's run_configs),
    merged into `out`."""
    device = resolve_device(device)
    info = card(device)
    table = _load_matrix(out)
    _put(table, "c0_index_build", config0_index_build(device), info)
    _put(table, "c1_sample_data", config1_sample_data(device), info)
    # Config 2: yeast-scale (~6k transcripts), 1M 100 bp reads, k = 31.
    _put(table, "c2_yeast_1m", timed_quant(synth_problem(6000, 1 << 20, 100, (31,), 21, device), device), info)
    # Config 3: chr20-scale (~20k isoforms), k = (21, 31), 2M reads (the
    # fused bound; BASELINE's 10M is chip_smoke's stream-c3).
    _put(table, "c3_chr20_multik", timed_quant(synth_problem(20000, 1 << 21, 100, (21, 31), 22, device), device),
         info)
    # Config 4 analogue: 50k isoforms, 4M reads through the streamed engine
    # (GENCODE scale is --configs-full's c4_gencode_* entries).
    problem = synth_problem(50000, 1 << 22, 150, (31,), 23, device)
    problem = problem._replace(config=dataclasses.replace(problem.config, stream_chunk_reads=1 << 20))
    with forced_streaming():
        entry = timed_quant(problem, device, repeats=1)
    _put(table, "c4_stream_50k_analogue", {"transcripts": 50000, "reads": 1 << 22,
                                           "note": "reduced-size streaming analogue; GENCODE scale is "
                                                   "c4_gencode_* (--configs-full)", **entry}, info)
    del problem
    if full:
        for name, entry in run_configs_full(device, cache_dir, fastq).items():
            _put(table, name, entry, info)
    # Config 5: multi-sample (8 x 50M on several hosts in BASELINE; here
    # 4 samples x 256k reads over one index).
    _put(table, "c5_multisample", config5_multisample(device), info)
    _save_matrix(out, table)
    print(json.dumps({"metric": "bench_matrix", "value": len(table), "unit": "configs", "out": str(out)}))
    return table


def run_configs_full(device, cache_dir: Path = SCALE_CACHE, fastq: Path = BIG_FASTQ) -> dict:
    """The GENCODE-scale entries (bench.py's run_configs_full): 250k
    isoforms at 2^20 reads of 150 bp, k = 31 and k = (21, 31) (fused),
    then the 32M-read FASTQ through the streamed engine."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.io.packing import PackedReads
    from sketch_rna_tpu_torch.utils.synth import gencode_transcriptome, sample_reads

    table = {}
    seqs = gencode_transcriptome()
    codes, lengths = sample_reads(seqs, 1 << 20, 150, 256, 7)
    for name, ks, cachef in (("c4_gencode_250k_1m_single_k", (31,), "T250000_k31.npz"),
                             ("c4_gencode_250k_1m_multik", (21, 31), "T250000_k21_31.npz")):
        artifact, why = load_gencode_index(Path(cache_dir) / cachef, ks)
        if artifact is None:
            table[name] = {"skipped": why}
            continue
        t0 = time.perf_counter()
        index = to_device(artifact, device)
        cfg = QuantConfig(kmer_lengths=ks, max_read_len=256, em_dtype="float32")
        problem = Problem(cfg, artifact, index, PackedReads(codes, lengths, []), seqs, time.perf_counter() - t0)
        table[name] = {"transcripts": index.num_transcripts, "reads": int(lengths.size),
                       **timed_quant(problem, device, repeats=2)}
        del problem, index
    table["c4_gencode_32m_streamed"] = stream32m_entry(device, cache_dir, fastq)
    return table


def stream32m_entry(device, cache_dir: Path = SCALE_CACHE, fastq: Path = BIG_FASTQ) -> dict:
    """The 32M-read file -> result run: the FASTQ's record scan on a
    background thread (native.LazyScanFeed, as the CLI's big-file route)
    overlapping the index upload, then quantify_streamed; timed from the
    scan's start to the result on the host."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.io import native
    from sketch_rna_tpu_torch.stream import quantify_streamed

    if not Path(fastq).exists():
        return {"skipped": f"missing {fastq} (scripts/make_fastq_torch.py)"}
    if not native.native_available():
        return {"skipped": "the native FASTQ parser did not build"}
    artifact, why = load_gencode_index(Path(cache_dir) / "T250000_k31.npz", (31,))
    if artifact is None:
        return {"skipped": why}
    cfg = QuantConfig(kmer_lengths=(31,), em_dtype="float32")
    t_all = time.perf_counter()
    feed = native.LazyScanFeed(str(fastq), 31, cfg.stream_chunk_reads, row_multiple=cfg.batch_size)
    try:
        index = to_device(artifact, device)
        result = quantify_streamed(index, feed, cfg)
    finally:
        feed.close()
    sync(device)
    dt = time.perf_counter() - t_all
    return {"transcripts": index.num_transcripts, "reads": result.num_reads,
            "reads_per_s": round(result.num_reads / dt, 1), "elapsed_s": round(dt, 2),
            "em_iterations": result.em_iterations, "phases_s": {k: round(v, 2) for k, v in result.timing.items()},
            "overflows": overflows(result.stats), "stream_classes": result.stats["stream_classes"]}


def run_stream32m_only(device="cuda", out: Path = OUT_DIR / "matrix.json", cache_dir: Path = SCALE_CACHE,
                       fastq: Path = BIG_FASTQ) -> dict:
    """The 32M streamed entry in a fresh process, merged into `out`."""
    device = resolve_device(device)
    entry = stream32m_entry(device, cache_dir, fastq)
    if "skipped" not in entry:
        table = _load_matrix(out)
        _put(table, "c4_gencode_32m_streamed", {**entry, "note": "fresh-process run (bench_torch.py --stream32m)"},
             card(device))
        _save_matrix(out, table)
    print(json.dumps({"metric": "stream32m", **entry}))
    return entry


def spread_entry(values: List[Optional[float]], n_requested: int, card_info: dict) -> dict:
    """--standard-spread's entry from each run's reads/s (None: a run that
    printed no result)."""
    vals = sorted(v for v in values if v is not None)
    return {"runs": values, "n": len(vals), "n_requested": n_requested,
            "median_reads_per_s": round(statistics.median(vals), 1), "min_reads_per_s": vals[0],
            "max_reads_per_s": vals[-1], "card": card_info,
            "note": "standard bench (2k transcripts, 131072 reads, k=31), N fresh processes; one code's runs "
                    "spread up to 1.5x, so the median is the headline"}


def run_standard_spread(n: int = 5, device="cuda", out: Path = OUT_DIR / "matrix.json") -> Optional[dict]:
    """The standard bench in n fresh processes: their median, min and max
    reads/s, merged into `out` as c_bench_standard."""
    dev = resolve_device(device)
    values = []
    for i in range(n):
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--device", str(device)],
                           capture_output=True, text=True, timeout=900)
        v = None
        for line in p.stdout.splitlines():
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(d, dict) and d.get("metric") == METRIC:
                v = d["value"]
        values.append(v)
        print(json.dumps({"spread_run": i, "value": v, "rc": p.returncode}), file=sys.stderr, flush=True)
    if all(v is None for v in values):
        print(json.dumps({"metric": "standard_spread", "skipped": "no run printed a result"}))
        return None
    entry = spread_entry(values, n, card(dev))
    table = _load_matrix(out)
    table["c_bench_standard"] = entry
    _save_matrix(out, table)
    print(json.dumps({"metric": "standard_spread", **entry}))
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--configs", action="store_true", help="BASELINE configs c0-c5")
    mode.add_argument("--configs-full", action="store_true", help="c0-c5 and the GENCODE-scale entries")
    mode.add_argument("--stream32m", action="store_true", help="the 32M-read FASTQ entry alone")
    mode.add_argument("--standard-spread", type=int, nargs="?", const=5, metavar="N",
                      help="the standard bench in N fresh processes (default 5)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", type=Path, default=OUT_DIR / "matrix.json", help="the matrix file results merge into")
    ap.add_argument("--cache-dir", type=Path, default=SCALE_CACHE,
                    help="scripts/scale_check_torch.py's index cache (the GENCODE-scale entries)")
    ap.add_argument("--fastq", type=Path, default=BIG_FASTQ, help="scripts/make_fastq_torch.py's 32M-read FASTQ")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    if args.standard_spread is not None:
        return 0 if run_standard_spread(args.standard_spread, args.device, args.out) else 1
    if args.stream32m:
        run_stream32m_only(args.device, args.out, args.cache_dir, args.fastq)
    elif args.configs or args.configs_full:
        run_configs(args.device, args.configs_full, args.out, args.cache_dir, args.fastq)
    else:
        run_standard(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
