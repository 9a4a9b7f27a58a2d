"""Quantification: sketch -> match -> classes -> EM -> CSV, one k or several.

Mirrors the JAX package's fused engine (pipeline._quantify_fused,
src/main.cpp:165-197 in the reference):

  - reads group by padded length exactly as pipeline._match_tables does
    (power-of-two pads >= 256, each group's codes cut to its longest
    read rounded up to 8, and to at least the largest k), so sketch
    capacities agree with the JAX run;
  - each batch of `batch_size` reads is sketched for every k (kernels
    K1/K2, or K3 + K4 for reads past 1024 windows; sketch/dispatch.py),
    probed in each k's bucket table (kernel P, match/bucket_lookup.py),
    expanded into one event row per read and k, and grouped into
    top-C candidates (kernel K4) — match/rowmatch.py.  Several ks group
    per k and intersect; a batch where a per-k table spilled is grouped
    again in merged mode, which truncates only the final set;
  - the [N, C] tables narrow to the widest candidate set, collapse into
    equivalence classes (when N >= 1024, as in the JAX engine), and run
    the EM + soft assignment (route: config.em_segsum, em/em.py em_route);
  - write_csv emits rows in transcript-index order (PARITY.md dev. 2).

Past FUSED_MAX_PADDED_READS, quantify streams (stream.py); both engines
share match_rows and em_assign.  quantify_samples runs several samples
against one index; config.em_checkpoint checkpoints the EM (_run_em).
quantify_sharded runs over a (data, index) mesh of rank processes
(dist/), on the streamed engine with the index hash-range sharded.

Posting expansion sizes each batch's event rows to its largest read, so
unlike the JAX engine there are no tier widths, calibration passes or
reruns to make the result exact.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em.classes import build_class_tables
from sketch_rna_tpu_torch.em.em import assign_reads_tables, em_route, run_em_tables
from sketch_rna_tpu_torch.index.artifact import DeviceIndex, IndexArtifact
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
from sketch_rna_tpu_torch.match.row_sort import row_sort_wide
from sketch_rna_tpu_torch.match.rowmatch import (
    MatchResult,
    group_event_parts,
    match_runs,
    pow2ceil,
    row_expand_from_runs,
)
from sketch_rna_tpu_torch.sketch.dispatch import sketch_ops, sketch_reads
from sketch_rna_tpu_torch.utils.profiling import maybe_trace
from sketch_rna_tpu_torch.utils.roofline import probe_shape_bytes
from sketch_rna_tpu_torch.utils.timing import PhaseTimer

log = logging.getLogger(__name__)

# One fused run holds every read's [N, C] candidate tables on the device;
# past this many padded reads quantify streams (stream.py).
FUSED_MAX_PADDED_READS = 1 << 21

# Lost work: nonzero means the result differs from the reference's.
LOSS_KEYS = ("sketch_overflow", "expand_dropped", "candidate_spilled")
# candidate_spilled_per_k counts per-k table spills before the
# intersection; every batch with one is regrouped in merged mode, so it
# costs time, not exactness.
STAT_KEYS = LOSS_KEYS + ("candidate_spilled_per_k",)


@dataclasses.dataclass
class QuantResult:
    """One quant's result: abundances, counts, CSV membership, stats,
    stage times and work counts.

    sizes: the work a fused quant did, counted on the host from the
    shapes the engine already knows (no device sync), the inputs of
    utils/roofline.py; empty from the streamed and sharded engines, as in
    the JAX package.  Keys:

      reads_padded  rows the sketch kernels took.  The port pads no batch,
                    so this is the read count; the JAX engine pads each
                    length group to whole batches, and the two agree when
                    batch_size divides every group.
      hash_windows  k-mer windows hashed: rows x (L - k + 1) a k, L a
                    group's width (its longest read rounded up to 8), as
                    the JAX engine counts them.
      hash_ops      the sketch's integer operations by utils/roofline.py's
                    rule (sketch/dispatch.py sketch_ops: 8 a code
                    position, 8 a window).  The JAX package counts k seed
                    XORs a window, its windowed XOR; the port's kernels
                    hash a window in O(1) from a prefix, so the two differ.
      probe_bytes   the most bytes the bucket probe can move at these
                    shapes (roofline.probe_shape_bytes: every sketch lane
                    masked in).  The JAX package counts its whole [key |
                    start | length] row gathered a lane; P reads only a
                    masked-in lane's key part, so the two differ.
      group_lanes   event lanes grouped: rows x the per-k row widths, each
                    k's batch maximum of events a read rounded up to a
                    power of two (a regrouped batch counts again).  The
                    JAX engine counts its tier plan's or expansion
                    budget's lanes, so the two differ.
      em_lanes      lanes of the EM's table: the equivalence-class table
                    (past 1024 padded reads) or the per-read one.
      em_width_max  the EM table's width.

    The last two equal the JAX package's where it builds one table of the
    same width (the per-read table); its class tables are tiered apart.
    """

    names: List[str]
    pi: np.ndarray  # [T] final EM abundances
    weighted_counts: np.ndarray  # [T] soft-assigned read counts
    has_entry: np.ndarray  # [T] bool: gets a CSV row
    em_iterations: int
    num_reads: int  # R (valid reads, incl. candidate-less)
    num_mapped: int  # reads with >= 1 candidate (sum of weighted_counts)
    stats: Dict[str, int]
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    lengths: Optional[np.ndarray] = None  # [T] true transcript lengths
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def csv_rows(self) -> List[Tuple[str, float, float]]:
        """(name, NumReads, EM_Abundance) of each CSV row, in transcript
        index order (the reference writes unordered_map order)."""
        return [
            (self.names[t], float(self.weighted_counts[t]), float(self.pi[t]))
            for t in range(len(self.names))
            if self.has_entry[t]
        ]

    def tpm(self) -> np.ndarray:
        """Transcripts per million from the soft-assigned counts and the
        real transcript lengths (the reference README promises TPM but
        never computes it)."""
        if self.lengths is None:
            raise ValueError("TPM needs the transcript lengths")
        lens = np.maximum(self.lengths.astype(np.float64), 1.0)
        rate = self.weighted_counts / lens
        total = rate.sum()
        return rate / total * 1e6 if total > 0 else rate


def _round_up(n: int, mult: int) -> int:
    return ((int(n) + mult - 1) // mult) * mult


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fold_ok(config: QuantConfig, num_transcripts: int) -> bool:
    """Is folding single-candidate classes out of the EM loop exact?

    A folded singleton assumes its E-step denominator pi[t]*count always
    exceeds em_epsilon.  Iteration 1 sees pi0 = 1/T (covered by
    T * epsilon < 1); every later pi[t] >= pseudocount (> epsilon when
    epsilon < pseudocount) or, with pseudocount 0, >= the folded base.
    """
    eps = config.em_epsilon
    if num_transcripts <= 0 or num_transcripts * eps >= 1.0:
        return False
    return eps < config.pseudocount or config.pseudocount == 0.0


def sketch_match_step(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    index: DeviceIndex,
    config: QuantConfig,
    sketch_caps: Sequence[int],
    *,
    sketch: Callable = sketch_reads,
    sort: Callable[[torch.Tensor], torch.Tensor] = row_sort_wide,
    lookup: Callable = probe_index,
) -> MatchResult:
    """One batch: sketch every k of the index, probe each k's bucket
    table, expand, group into top-C candidates (config.match_per_k_tables
    picks the K > 1 mode); a read past 16384 events at some k groups in
    a row slice of its own (match_runs).

    sketch / sort / lookup: the kernels by default (sketch_reads, K4 and
    past its widest row the merge kernel, the bucket probe P); their
    plain versions (sketch_all_k, row_sort_plain,
    bucket_lookup.probe_index_plain) check them on the same batch.
    lookup(hashes, mask, DeviceKIndex) -> (start, length).
    Stats: sketch_overflow summed over ks, candidate_spilled,
    candidate_spilled_per_k, and expand_dropped, always 0 (the JAX
    engines' key: the port drops no event).
    """
    ks = tuple(index.kmer_lengths)
    sketches = sketch(codes, lengths, ks, config.sketch_fraction, sketch_caps)
    runs = [lookup(h, m, index.per_k[k]) for (h, m, _), k in zip(sketches, ks)]

    def group(runs, sizes):
        parts = [row_expand_from_runs(start, length, index.per_k[k].postings, sizes=size)
                 for (start, length), k, size in zip(runs, ks, sizes)]
        res = group_event_parts(
            parts,
            chain_fraction=config.chain_fraction,
            candidate_capacity=config.candidate_capacity,
            num_transcripts=index.num_transcripts,
            per_k_tables=config.match_per_k_tables,
            sort=sort,
        )
        res.lanes = sum(key.numel() for key in parts)
        return res

    res = match_runs(runs, config.batch_size, group)
    res.stats["sketch_overflow"] = sum(ov for _, _, ov in sketches)
    res.stats["expand_dropped"] = torch.zeros((), dtype=torch.int64, device=codes.device)
    return res


def length_groups(lengths: np.ndarray, padded_len: int) -> List[Tuple[int, Union[slice, np.ndarray]]]:
    """The reads' padded-length groups, as the JAX engine forms them:
    (pad, rows) in ascending pad, pad a power of two >= 256 cut to
    padded_len, rows a slice of every read when there is one group."""
    pad_of = np.maximum(256, 1 << np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64))
    pads = np.minimum(pad_of, max(int(padded_len), 256))
    unique_pads = sorted(set(pads.tolist()))
    if len(unique_pads) == 1:
        return [(unique_pads[0], slice(None))]
    return [(pad, np.flatnonzero(pads == pad)) for pad in unique_pads]


def match_rows(index: DeviceIndex, codes: torch.Tensor, lengths: np.ndarray, config: QuantConfig,
               step: Callable[..., MatchResult] = sketch_match_step, sizes: Optional[Dict[str, int]] = None):
    """Candidate tables of every read, grouped by padded length as the
    JAX engine groups them (length_groups).

    step: what matches one batch, with sketch_match_step's first five
    parameters (the sharded engine's gathers events over the index
    group).  The batches and their order depend on the reads alone, in
    ascending order of padded length: ranks that hold the same reads run
    the same sequence of steps.

    codes: [N, L] uint8 on the host or already on the index's device;
    each group's rows, cut to the group's width, move to the device once.
    lengths: [N] host lengths.  Returns (tid [N', C] int32, score [N', C]
    int32, padded row count of the JAX engine, stats of 0-d tensors); the
    rows follow the groups, not the input order.  sizes: a dict that
    receives QuantResult.sizes' match keys (the step's tables must carry
    `lanes`, as sketch_match_step's do).
    """
    ks = tuple(index.kmer_lengths)
    dev = index.device
    B = config.batch_size
    lengths_np = np.asarray(lengths)
    results: List[MatchResult] = []
    batches = []  # (codes, lengths, caps) of each result, to regroup it
    n_padded = 0
    for pad, rows in length_groups(lengths_np, codes.shape[1]):
        n_rows = int(lengths_np[rows].size)
        width = min(pad, codes.shape[1])
        l_eff = min(width, _round_up(max(int(lengths_np[rows].max()), max(ks)), 8))
        sel = rows if isinstance(rows, slice) else torch.from_numpy(rows).to(codes.device)
        group = codes[sel, :l_eff].contiguous().to(dev)
        group_lengths = torch.from_numpy(lengths_np[rows].astype(np.int32)).to(dev)
        caps = tuple(config.sketch_capacity_for(k, l_eff) for k in ks)
        n_padded += _round_up(n_rows, B)
        for b0 in range(0, n_rows, B):
            c, n = group[b0 : b0 + B], group_lengths[b0 : b0 + B]
            results.append(step(c, n, index, config, caps))
            batches.append((c, n, caps))
            if sizes is not None:
                _count_batch(sizes, index, c.shape[0], l_eff, caps)
    if len(ks) > 1 and config.match_per_k_tables:
        # A per-k table that spilled makes its batch's intersection
        # inexact: group those batches again as merged K-wide rows, which
        # give the tables of the JAX engine's whole-run merged rerun.
        spilled = torch.stack([r.stats["candidate_spilled_per_k"] for r in results]).tolist()
        merged = dataclasses.replace(config, match_per_k_tables=False)
        for i in np.flatnonzero(spilled):
            c, n, caps = batches[i]
            redo = step(c, n, index, merged, caps)
            redo.stats["candidate_spilled_per_k"] = results[i].stats["candidate_spilled_per_k"]
            redo.lanes += results[i].lanes
            results[i] = redo
        if any(spilled):
            log.info("per-k candidate tables spilled in %d of %d batches; regrouped them merged",
                     int(np.count_nonzero(spilled)), len(results))
    if sizes is not None:
        sizes["group_lanes"] = sizes.get("group_lanes", 0) + sum(r.lanes for r in results)
    stats = {key: sum(r.stats[key] for r in results) for key in STAT_KEYS}
    return torch.cat([r.tid for r in results]), torch.cat([r.score for r in results]), n_padded, stats


def _count_batch(sizes: Dict[str, int], index: DeviceIndex, rows: int, width: int, caps: Sequence[int]) -> None:
    """Add one batch of `rows` reads cut to `width` to the sizes' sketch
    and probe counts (QuantResult.sizes)."""
    ks = tuple(index.kmer_lengths)
    add = {
        "reads_padded": rows,
        "hash_windows": sum(rows * max(width - k + 1, 0) for k in ks),
        "hash_ops": sketch_ops(rows, width, ks),
        "probe_bytes": sum(probe_shape_bytes(rows * cap, index.per_k[k].bucket.mb) for k, cap in zip(ks, caps)),
    }
    for key, v in add.items():
        sizes[key] = sizes.get(key, 0) + v


def collect_pairs(index: DeviceIndex, packed: PackedReads, config: QuantConfig):
    """Every read's candidates as flat host pairs: (read row, tid, score)
    int32 arrays, rows in the packed reads' order and each row's pairs by
    (score desc, tid asc), plus the loss stats expand_dropped,
    candidate_spilled and sketch_overflow as ints (match_rows, the fused
    engine's matching, on the index's device)."""
    tid, score, _, stats = match_rows(index, torch.from_numpy(packed.codes), packed.lengths, config)
    groups = length_groups(np.asarray(packed.lengths), packed.codes.shape[1])
    order = np.arange(packed.num_reads) if len(groups) == 1 else np.concatenate([rows for _, rows in groups])
    tid_np, score_np = tid.cpu().numpy(), score.cpu().numpy()
    row, col = np.nonzero(score_np > 0)  # a candidate scores >= 1
    read = order[row]
    keep = np.argsort(read, kind="stable")
    pairs = (read[keep].astype(np.int32), tid_np[row, col][keep], score_np[row, col][keep])
    return (*pairs, {key: int(stats[key]) for key in LOSS_KEYS})


def _empty_result(index: DeviceIndex) -> QuantResult:
    """Zero valid reads: a header-only CSV, as the reference would write."""
    T = index.num_transcripts
    return QuantResult(
        names=list(index.names),
        pi=np.full(T, 1.0 / max(T, 1)),
        weighted_counts=np.zeros(T),
        has_entry=np.zeros(T, dtype=bool),
        em_iterations=0,
        num_reads=0,
        num_mapped=0,
        stats={},
        lengths=np.asarray(index.lengths),
    )


def _run_em(tables, num_reads: int, num_transcripts: int, config: QuantConfig, route: Dict[str, object],
            static_base=None, group=None):
    """The EM loop, with config.em_checkpoint's periodic checkpoints.

    With a checkpoint path, the iteration budget runs in segments of
    em_checkpoint_every; the state is saved after each segment, and a
    fresh call resumes from a saved (pi, iteration).  Segmenting is
    exact: each segment re-enters with the pi and iteration an
    uninterrupted loop would have, and the `converged` flag stops a run
    from taking an extra E-step after an early stop.  route: em_route's;
    every segment shares its segsum plan.
    Returns (pi, iterations).
    """
    kw = dict(
        num_transcripts=num_transcripts,
        convergence_threshold=config.em_convergence,
        pseudocount=config.pseudocount,
        epsilon=config.em_epsilon,
        dtype=config.em_dtype,
        static_base=static_base,
        group=group,
        **route,
    )
    if not config.em_checkpoint:
        pi, iterations, _ = run_em_tables(tables, num_reads, max_iterations=config.em_max_iterations, **kw)
        return pi, iterations

    from sketch_rna_tpu_torch.em.checkpoint import (
        EMState,
        check_resumable,
        fingerprint_of,
        load_em_state,
        save_em_state,
    )

    path = config.em_checkpoint
    fp = fingerprint_of(num_transcripts, num_reads, config)
    dev = tables[0][0].device
    pi, it = None, 0
    if os.path.exists(path):
        state = load_em_state(path)
        check_resumable(state, fp)
        pi, it = torch.from_numpy(np.asarray(state.pi)).to(dev), state.iterations_done
        log.info("resuming EM from %s at iteration %d", path, it)
    every = max(config.em_checkpoint_every, 1)
    while it < config.em_max_iterations:
        bound = min(it + every, config.em_max_iterations)
        pi, it, done = run_em_tables(tables, num_reads, max_iterations=bound, init_pi=pi, start_iteration=it, **kw)
        save_em_state(path, EMState(pi.cpu().numpy(), it, num_reads, fp))
        if done:
            break
    if pi is None:  # no budget at all: the uniform start
        pi = torch.full((num_transcripts,), 1.0 / num_transcripts, dtype=torch.float64, device=dev)
    return pi, it


def em_assign(tables, static_base, static_has, index: DeviceIndex, config: QuantConfig, *, num_reads: int,
              num_mapped: int, stats: Dict[str, int], timing: Dict[str, float], group=None) -> QuantResult:
    """EM (with checkpoints) + soft assignment over weighted tables, timed
    into timing["em_assign"]; the QuantResult of every engine.  The route
    (em/em.py em_route) is resolved once, and a segsum plan
    built once, over this process's tables.  group: the data group whose
    ranks each hold a share of the classes (em/em.py); num_reads and
    num_mapped are then the global counts."""
    t0 = time.perf_counter()
    names = index.names
    T = len(names)
    route = em_route(tables, T, config)
    pi, iterations = _run_em(tables, num_reads, T, config, route, static_base=static_base, group=group)
    pi = pi.to(tables[0][0].device, torch.float64 if config.em_dtype == "float64" else torch.float32)
    weighted, has_entry = assign_reads_tables(
        tables,
        pi,
        num_transcripts=T,
        dtype=config.em_dtype,
        static_base=static_base,
        static_has=static_has,
        group=group,
        **route,
    )
    result = QuantResult(
        names=list(names),
        pi=pi.cpu().numpy(),
        weighted_counts=weighted.cpu().numpy(),
        has_entry=has_entry.cpu().numpy(),
        em_iterations=iterations,
        num_reads=num_reads,
        num_mapped=num_mapped,
        stats=stats,
        timing=timing,
        lengths=np.asarray(index.lengths),
    )
    timing["em_assign"] = time.perf_counter() - t0
    return result


def streams(num_reads: int, config: QuantConfig) -> bool:
    """Does quantify stream this many reads (past the fused bound)?"""
    return _round_up(num_reads, config.batch_size) > FUSED_MAX_PADDED_READS


def quantify(
    index: DeviceIndex,
    packed: PackedReads,
    config: Optional[QuantConfig] = None,
) -> QuantResult:
    """Full quant on the index's device: sketch -> match -> EM ->
    assignment (src/main.cpp:165-197).

    Runs the fused engine when the padded read count fits
    FUSED_MAX_PADDED_READS, and streams through the fixed class buffer of
    stream.quantify_streamed past it (O(buffer) device memory at any
    read count), as the JAX package routes.  A fused run reports
    timing["quant_fused"] and timing["quant_fused_per_s"] (reads/s), its
    clock read after the device has finished; both engines report the
    index's set-up, timing["index_upload"] (to_device, bucket tables
    included).  SKETCH_TPU_PROFILE traces either engine
    (utils/profiling.py).
    """
    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    R = packed.num_reads
    if R == 0:
        return _empty_result(index)
    if streams(R, config):
        from sketch_rna_tpu_torch.stream import quantify_streamed

        with maybe_trace("quant_streamed"):
            return quantify_streamed(index, packed, config)
    timer = PhaseTimer()
    with maybe_trace("quant_fused"), timer.phase("quant_fused", items=R, device=index.device):
        result = _quantify_fused(index, packed, config)
    result.timing.update(timer.report())
    return result


def _quantify_fused(index: DeviceIndex, packed: PackedReads, config: QuantConfig) -> QuantResult:
    """The fused engine: every read's candidate table on the device at once."""
    R = packed.num_reads
    T = index.num_transcripts
    dev = index.device
    timing: Dict[str, float] = {"index_upload": index.upload_s}

    t0 = time.perf_counter()
    sizes: Dict[str, int] = {}
    tbl_tid, tbl_score, n_padded, stats = match_rows(index, torch.from_numpy(packed.codes), packed.lengths, config,
                                                     sizes=sizes)
    host_stats = {key: int(v) for key, v in stats.items()}
    for key in LOSS_KEYS:
        if host_stats[key]:
            log.warning("capacity overflow during matching: %s=%d", key, host_stats[key])
    timing["match"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # Rows are rank-ordered, so narrowing to the widest candidate set
    # (pow2) is lossless.
    n_cand = (tbl_score > 0).sum(dim=1)
    n_cand_max, num_mapped = (int(v) for v in torch.stack([n_cand.max(), (n_cand > 0).sum()]).tolist())
    W = min(pow2ceil(max(n_cand_max, 1)), config.candidate_capacity)
    tbl_tid = tbl_tid[:, :W]
    tbl_score = tbl_score[:, :W]
    if n_padded >= 1024:
        table, static_base, static_has = build_class_tables(
            tbl_tid, tbl_score, num_transcripts=T, fold=_fold_ok(config, T)
        )
    else:
        table, static_base, static_has = (tbl_tid, tbl_score, None), None, None
    _sync(dev)
    timing["classes"] = time.perf_counter() - t0

    sizes["em_lanes"], sizes["em_width_max"] = table[0].numel(), table[0].shape[1]
    result = em_assign([table], static_base, static_has, index, config, num_reads=R, num_mapped=num_mapped,
                       stats=host_stats, timing=timing)
    result.sizes = sizes
    return result


def quantify_sharded(
    index: Union[IndexArtifact, DeviceIndex],
    packed: PackedReads,
    config: Optional[QuantConfig] = None,
    mesh=None,
    local_slice: bool = False,
    device: str = "cuda",
) -> QuantResult:
    """Quant over a (data, index) mesh of rank processes, one per GPU: the
    reads split over the data axis, the index hash-range sharded over the
    index axis, the EM all-reduced over the data axis each iteration
    (dist/quant_stream.py).  Every rank of the process group calls this
    collectively and gets the same QuantResult, equal to quantify()'s on
    the same reads but for float summation order.

    index: the artifact on the host (this rank's shard of it is uploaded
    to the mesh's device), or a DeviceIndex that already is this rank's
    shard (index/shard.shard_to_device), as a caller with several samples
    passes.  mesh: dist.mesh.make_mesh's; None makes one over every rank
    of the process group (one rank without one), split by mesh_factor
    with the index's device bytes, on `device` ("cuda": the rank's card,
    or "cpu").  packed: every
    rank's whole read set, of which rank (d, i) takes part d of dp; with
    local_slice, this rank's own part d already (dist/multihost.py).
    Always streams (O(chunk + class buffer) device memory) and always
    groups merged.
    """
    from sketch_rna_tpu_torch.dist.init import rank_device
    from sketch_rna_tpu_torch.dist.mesh import index_device_bytes, make_mesh, mesh_factor, world
    from sketch_rna_tpu_torch.dist.multihost import quantify_sharded_multihost
    from sketch_rna_tpu_torch.dist.quant_stream import quantify_rank
    from sketch_rna_tpu_torch.index.shard import shard_to_device

    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    if mesh is None:
        if isinstance(index, DeviceIndex):
            raise ValueError("an index shard belongs to a mesh: pass the mesh it was cut for")
        mesh = make_mesh(*mesh_factor(world()[1], index_bytes=index_device_bytes(index)),
                         device=rank_device(device))
    shard = index if isinstance(index, DeviceIndex) else shard_to_device(index, mesh.ip, mesh.i, mesh.device)
    with maybe_trace("quant_sharded"):
        if local_slice:
            return quantify_sharded_multihost(shard, packed, config, mesh)
        R = packed.num_reads
        if R == 0:  # every rank holds the same reads, so all agree
            return _empty_result(shard)
        r0, r1 = (R * mesh.d) // mesh.dp, (R * (mesh.d + 1)) // mesh.dp
        mine = PackedReads(packed.codes[r0:r1], packed.lengths[r0:r1], [])
        return quantify_rank(shard, mine, config, mesh, R)


def quantify_samples(
    index: Union[IndexArtifact, DeviceIndex],
    samples: Dict[str, Union[PackedReads, Callable[[], PackedReads]]],
    config: Optional[QuantConfig] = None,
    sharded: bool = False,
    mesh=None,
    local_slice: bool = False,
) -> Dict[str, QuantResult]:
    """Quantify several samples against one loaded index, in turn.

    A value is a PackedReads, or a callable that returns one: it defers
    the parse + pack to the sample's turn, so host memory holds one
    sample's reads at a time.  sharded runs each sample through
    quantify_sharded with mesh and local_slice (pass this rank's index
    shard so that it uploads once); else index is a DeviceIndex.
    """
    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    if sharded:
        def quant(reads):
            return quantify_sharded(index, reads, config, mesh, local_slice)
    else:
        def quant(reads):
            return quantify(index, reads, config)
    return {name: quant(reads() if callable(reads) else reads) for name, reads in samples.items()}


def format_cpp_double(v: float) -> str:
    """C++ default ostream double formatting: %g with 6 significant
    digits (src/data_io.cpp:148 uses the stream defaults)."""
    return f"{v:.6g}"


def write_csv(path: str, result: QuantResult, with_tpm: bool = False) -> None:
    """CSV schema of output_to_csv (src/data_io.cpp:133-152): header
    Name,NumReads,EM_Abundance; rows only for transcripts with a read
    entry, in transcript-index order.  with_tpm appends a TPM column
    (the reference README promises TPM but never computes it)."""
    tpm = result.tpm() if with_tpm else None
    with open(path, "w") as fh:
        fh.write("Name,NumReads,EM_Abundance,TPM\n" if with_tpm else "Name,NumReads,EM_Abundance\n")
        for t in range(len(result.names)):
            if not result.has_entry[t]:
                continue
            row = (
                f"{result.names[t]},{format_cpp_double(float(result.weighted_counts[t]))},"
                f"{format_cpp_double(float(result.pi[t]))}"
            )
            if with_tpm:
                row += f",{format_cpp_double(float(tpm[t]))}"
            fh.write(row + "\n")
