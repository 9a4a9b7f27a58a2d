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
    expanded into one event row per read and k (kernel E,
    match/expand.py), and grouped into top-C candidates (kernel G, or
    past its 1,024-lane rows K4 and PyTorch operations) —
    match/rowmatch.py.  match_scan, the JAX engine's counterpart, does
    it with one host read a length group, replaying each batch's steps
    from CUDA graphs on a card (utils/step_graphs.py).  Several ks group
    per k and intersect; a batch where a per-k table spilled is grouped
    again in merged mode, which truncates only the final set;
  - the [N, C] tables narrow to the widest candidate set, collapse into
    equivalence classes split into width tiers (em_tables: when N >= 1024
    and config.em_equivalence_classes, as in the JAX engine), and run the
    EM + soft assignment over the tiers (route: config.em_segsum,
    em/em.py em_route);
  - write_csv emits rows in transcript-index order (PARITY.md dev. 2).

Past FUSED_MAX_PADDED_READS, quantify streams (stream.py); both engines
share match_rows and em_assign.  quantify_samples runs several samples
against one index; config.em_checkpoint checkpoints the EM (_run_em).
quantify_sharded runs over a (data, index) mesh of rank processes
(dist/), on the streamed engine with the index hash-range sharded.

Posting expansion sizes each batch's event rows to its largest read, so
unlike the JAX engine the matcher has no tier widths, calibration passes
or reruns to make the result exact.  The EM's class tables do keep the
JAX engine's width tiers (em/classes.py): they cut the lanes each
iteration's posterior sum runs over.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em.classes import build_class_tables
from sketch_rna_tpu_torch.em.em import assign_reads_tables, em_route, run_em_tables
from sketch_rna_tpu_torch.index.artifact import DeviceIndex, IndexArtifact
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.match.bucket_lookup import probe_index
from sketch_rna_tpu_torch.match.expand import row_expand
from sketch_rna_tpu_torch.match.group import group_kernel_takes
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, row_sort_wide
from sketch_rna_tpu_torch.match.rowmatch import (
    MatchResult,
    Read,
    _read_local,
    event_size_tensor,
    event_sizes,
    expand_width,
    group_event_parts,
    match_runs,
    pow2ceil,
)
from sketch_rna_tpu_torch.sketch.dispatch import fused_groups, sketch_reads
from sketch_rna_tpu_torch.utils.profiling import maybe_trace
from sketch_rna_tpu_torch.utils.step_graphs import StepGraphs
from sketch_rna_tpu_torch.utils.timing import count, declare, host_read, phase, quant_call

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
    """One quant's result: abundances, counts, CSV membership, stats
    and stage times.

    timing: the call's span seconds and counters (utils/timing.py): the
    stages match (fused) or stream_match, classes, em_assign, a fused
    run's quant_fused and quant_fused_per_s (reads/s), index_upload
    (to_device's seconds); graphs.capture (seconds in CUDA-graph
    captures); the counters graphs.captures, graphs.replays,
    graphs.evictions, graphs.reserved_bytes, match.groups (length groups matched, summed over a stream's chunks),
    match.host_reads (blocking device-to-host reads of the match stage,
    each counted once where the program asks for it: a torch.unique or a
    boolean-mask index of the streamed class dedup too, and K3's kept
    width, one a batch slice and k that K3 sketches),
    match.eager_batches (batches whose sketch ran eagerly because their
    length group takes K3) with the span match.eager_sketch (seconds in
    those groups' phase 1), match.group_kernel_batches (batches the
    grouping kernel G grouped whole), em.iterations, and in a streamed
    run the counter stream.chunks with the span stream.upload (the
    chunks' host-to-device copies and unpacks).  A quant that retries (a
    streamed wide-block spill) reports the retry alone.
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


# The EM's width tiers (em/classes.py), as in the JAX engine: classes with
# at most _EM_NARROW_WIDTH candidates go to the narrow [*, 4] table, those
# with up to _EM_MID_WIDTH to the mid [*, 8] one, wider ones to the [*, W]
# one, and classes of exactly two candidates to the pair [*, 2] table.
_EM_NARROW_WIDTH = 4
_EM_MID_WIDTH = 8
_EM_PAIR_WIDTH = 2


def _fold_ok(config: QuantConfig, num_transcripts: int) -> bool:
    """Is folding single-candidate classes out of the EM loop asked for
    (config.em_fold_singletons) and exact?

    A folded singleton assumes its E-step denominator pi[t]*count always
    exceeds em_epsilon.  Iteration 1 sees pi0 = 1/T (covered by
    T * epsilon < 1); every later pi[t] >= pseudocount (> epsilon when
    epsilon < pseudocount) or, with pseudocount 0, >= the folded base.
    """
    eps = config.em_epsilon
    if not config.em_fold_singletons or num_transcripts <= 0 or num_transcripts * eps >= 1.0:
        return False
    return eps < config.pseudocount or config.pseudocount == 0.0


def em_tables(tbl_tid: torch.Tensor, tbl_score: torch.Tensor, config: QuantConfig, *, num_transcripts: int,
              n_rows: int, row_weight: Optional[torch.Tensor] = None):
    """The EM's working set (sketch_rna_tpu/pipeline.py _em_tables): the
    [N, W] rows (rank-ordered; row_weight [N] or None for 1 each) as
    equivalence classes in width tiers with the singletons folded
    (em/classes.py build_class_tables), or, with
    config.em_equivalence_classes off, the rows themselves split into a
    narrow [*, 4] and a wide [*, W] table.  n_rows: the rows as the JAX
    engine counts them (the fused engine's padded reads, a class
    buffer's capacity); below 1024 the rows stay one table, as there.

    Returns (tables, static_base, static_has), the static pair (None,
    None) unless singletons fold.
    """
    W = tbl_tid.shape[1]
    if config.em_equivalence_classes and n_rows >= 1024:
        return build_class_tables(tbl_tid, tbl_score, num_transcripts=num_transcripts,
                                  fold=_fold_ok(config, num_transcripts), n_rows=n_rows, row_weight=row_weight,
                                  narrow_width=_EM_NARROW_WIDTH, mid_width=_EM_MID_WIDTH, pair_width=_EM_PAIR_WIDTH)
    if W <= _EM_NARROW_WIDTH or n_rows < 1024:
        return [(tbl_tid, tbl_score, row_weight)], None, None
    wide = (tbl_score > 0).sum(dim=1) > _EM_NARROW_WIDTH
    n = _EM_NARROW_WIDTH
    if not bool(wide.any()):  # rank-ordered rows: the columns past n are zero
        return [(tbl_tid[:, :n], tbl_score[:, :n], row_weight)], None, None
    tables = [(tbl_tid[rows, :w], tbl_score[rows, :w], None if row_weight is None else row_weight[rows])
              for rows, w in ((~wide, n), (wide, W))]
    return [t for t in tables if t[0].shape[0]], None, None


def group_runs(runs: Sequence[Tuple[torch.Tensor, torch.Tensor]], widths: Sequence[int], index: DeviceIndex,
               config: QuantConfig, *, sort: Callable[[torch.Tensor], torch.Tensor] = row_sort_wide) -> MatchResult:
    """Expand each k's posting runs ((start, length) [B, S]) into [B, W_k]
    event rows (kernel E), W_k = widths[k], and group them into top-C
    candidates (config.match_per_k_tables picks the K > 1 mode).  Reads
    nothing to the host: at fixed widths its shapes are static."""
    ks = tuple(index.kmer_lengths)
    parts = [row_expand(start, length, index.per_k[k].postings, W) for (start, length), k, W in zip(runs, ks, widths)]
    return group_event_parts(
        parts,
        chain_fraction=config.chain_fraction,
        candidate_capacity=config.candidate_capacity,
        num_transcripts=index.num_transcripts,
        per_k_tables=config.match_per_k_tables,
        sort=sort,
    )


def _group_kernel_batch(most: Sequence[int], index: DeviceIndex, config: QuantConfig) -> bool:
    """Whether the kernel G groups a whole batch whose reads' largest
    per-k event totals are `most` (the rows of a batch that match_runs
    slices group slice by slice, and are not counted as such)."""
    return max(most) <= MAX_WIDTH and group_kernel_takes([expand_width(m) for m in most],
                                                         config.match_per_k_tables, index.device)


def _grouper(index: DeviceIndex, config: QuantConfig, sort: Callable[[torch.Tensor], torch.Tensor] = row_sort_wide):
    """match_runs' group: group_runs at each k's width for its largest
    per-read event total."""
    return lambda runs, most: group_runs(runs, [expand_width(m) for m in most], index, config, sort=sort)


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
    table, read the event sizes (one host sync), expand and group into
    top-C candidates (group_runs); a read past 16384 events at some k
    groups in a row slice of its own (match_runs).  The per-batch route
    (match_rows with a step); match_scan runs the same functions with one
    host read a length group.

    sketch / sort / lookup: the kernels by default (sketch_reads, the
    grouping kernel G, and where G does not take a batch K4 and past its
    widest row the merge kernel, the bucket probe P); their plain versions
    (sketch_all_k, row_sort_plain, which also takes the plain grouping
    chain, bucket_lookup.probe_index_plain) check them on the same batch.
    lookup(hashes, mask, DeviceKIndex) -> (start, length).
    Stats: sketch_overflow summed over ks, candidate_spilled,
    candidate_spilled_per_k, and expand_dropped, always 0 (the JAX
    engines' key: the port drops no event).  A batch that the kernel G
    groups whole counts one match.group_kernel_batches, as in match_scan.
    """
    ks = tuple(index.kmer_lengths)
    sketches = sketch(codes, lengths, ks, config.sketch_fraction, sketch_caps)
    runs = [lookup(h, m, index.per_k[k]) for (h, m, _), k in zip(sketches, ks)]
    sizes = event_sizes([length for _, length in runs])
    if sort is row_sort_wide and _group_kernel_batch(sizes, index, config):
        count("match.group_kernel_batches")
    res = match_runs(runs, config.batch_size, _grouper(index, config, sort), sizes=sizes)
    res.stats["sketch_overflow"] = sum(ov for _, _, ov in sketches)
    res.stats["expand_dropped"] = torch.zeros((), dtype=torch.int64, device=codes.device)
    return res


def length_groups(lengths: np.ndarray, padded_len: int) -> List[Tuple[int, Union[slice, np.ndarray]]]:
    """The reads' padded-length groups, as the JAX engine forms them:
    (pad, rows) in ascending pad, pad a power of two >= 256 cut to
    padded_len, rows a slice of every read when there is one group."""
    lengths = np.asarray(lengths)
    if lengths.size and int(lengths.max()) <= 256:  # every read pads to 256 (a million reads' pads cost ~20 ms)
        return [(256, slice(None))]
    pad_of = np.maximum(256, 1 << np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64))
    pads = np.minimum(pad_of, max(int(padded_len), 256))
    unique_pads = np.unique(pads).tolist()
    if len(unique_pads) == 1:
        return [(unique_pads[0], slice(None))]
    return [(pad, np.flatnonzero(pads == pad)) for pad in unique_pads]


def _pinned(x: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, or x's rows `rows`, copied into page-locked host memory (torch's
    caching host allocator, which keeps the block until the copies that
    read it end).  Rows are gathered straight into the pinned block: one
    pass over their bytes, where a gather and then a copy takes two."""
    if rows is None:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x)
    out = torch.empty((rows.numel(),) + tuple(x.shape[1:]), dtype=x.dtype, pin_memory=True)
    return torch.index_select(x, 0, rows, out=out)


def _groups(index: DeviceIndex, codes: torch.Tensor, lengths_np: np.ndarray, config: QuantConfig):
    """Each length group (length_groups, in ascending pad) on the index's
    device: (rows, l_eff, codes [rows, l_eff] uint8, lengths [rows] int32,
    each k's sketch capacity at l_eff).  Host rows bound for a card are
    staged in pinned memory, so their upload is an asynchronous copy that
    queues behind the device's work: from pageable memory the copy would
    first wait for the stream to drain, a host round trip a group that no
    count of synchronizing calls shows."""
    ks = tuple(index.kmer_lengths)
    pin = index.device.type == "cuda" and codes.device.type == "cpu"
    for pad, rows in length_groups(lengths_np, codes.shape[1]):
        count("match.groups")
        n_rows = int(lengths_np[rows].size)
        width = min(pad, codes.shape[1])
        l_eff = min(width, _round_up(max(int(lengths_np[rows].max()), max(ks)), 8))
        sel = None if isinstance(rows, slice) else torch.from_numpy(rows).to(codes.device)
        group_lengths = torch.from_numpy(lengths_np[rows].astype(np.int32))
        if pin:
            group, group_lengths = _pinned(codes[:, :l_eff], sel), _pinned(group_lengths)
        else:
            group = codes[:, :l_eff] if sel is None else codes[sel, :l_eff]
        yield (n_rows, l_eff, group.contiguous().to(index.device, non_blocking=True),
               group_lengths.to(index.device, non_blocking=True),
               tuple(config.sketch_capacity_for(k, l_eff) for k in ks))


_SPILLED, _SPILLED_PER_K = STAT_KEYS.index("candidate_spilled"), STAT_KEYS.index("candidate_spilled_per_k")


def _stat_row(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A batch's stats as one [len(STAT_KEYS)] int64 row."""
    return torch.stack([stats[key].to(torch.int64) for key in STAT_KEYS])


@dataclasses.dataclass
class _Group:
    """One length group's batches, as both match routes fill them: their
    inputs (`batch` reads each; match_scan pads the last one to that with
    empty reads), tables [nb, 2, batch, C] int32 (tid, score) and stats
    [nb, len(STAT_KEYS)] int64 (_stat_row)."""

    n_rows: int
    batch: int
    caps: Tuple[int, ...]
    inputs: List[Tuple[torch.Tensor, torch.Tensor]]
    tables: torch.Tensor
    stats: torch.Tensor

    @classmethod
    def alloc(cls, n_rows: int, batch: int, caps: Tuple[int, ...], inputs, C: int, device) -> "_Group":
        nb = len(inputs)
        return cls(n_rows, batch, caps, inputs, torch.empty((nb, 2, batch, C), dtype=torch.int32, device=device),
                   torch.empty((nb, len(STAT_KEYS)), dtype=torch.int64, device=device))

    def real(self, b: int) -> int:
        """Reads of batch b that are not padding."""
        return min(self.batch, self.n_rows - b * self.batch)

    def put(self, b: int, res: MatchResult) -> None:
        """Batch b's tables and stats from the MatchResult of its real reads."""
        real = self.real(b)
        self.tables[b, 0, :real], self.tables[b, 1, :real] = res.tid, res.score
        self.stats[b] = _stat_row(res.stats)


def match_rows(index: DeviceIndex, codes: torch.Tensor, lengths: np.ndarray, config: QuantConfig,
               step: Optional[Callable[..., MatchResult]] = None):
    """Candidate tables of every read, grouped by padded length as the
    JAX engine groups them (length_groups).

    step: None, the default, runs match_scan (one host read a length
    group, the batch steps replayed from CUDA graphs on a card).  Else
    what matches one batch, with sketch_match_step's first five
    parameters, called batch by batch (the sharded engine's gathers events
    over the index group; sketch_match_step itself is the per-batch
    route, which match_scan equals).  The batches and their order depend
    on the reads alone, in ascending order of padded length: ranks that
    hold the same reads run the same sequence of steps.

    codes: [N, L] uint8 on the host or already on the index's device;
    each group's rows, cut to the group's width, move to the device once.
    lengths: [N] host lengths.  Returns (tid [N', C] int32, score [N', C]
    int32, padded row count of the JAX engine, stats of 0-d tensors); the
    rows follow the groups, not the input order.
    """
    if step is None:
        return match_scan(index, codes, lengths, config)
    B = config.batch_size
    groups: List[_Group] = []
    n_padded = 0
    for n_rows, _, group, group_lengths, caps in _groups(index, codes, np.asarray(lengths), config):
        n_padded += _round_up(n_rows, B)
        inputs = list(zip(group.split(B), group_lengths.split(B)))
        g = _Group.alloc(n_rows, min(B, n_rows), caps, inputs, config.candidate_capacity, index.device)
        groups.append(g)
        for b, (c, n) in enumerate(inputs):
            g.put(b, step(c, n, index, config, caps))
    return _match_tables(groups, index, config, step, n_padded)


def _match_tables(groups: List[_Group], index: DeviceIndex, config: QuantConfig, regroup: Callable[..., MatchResult],
                  n_padded: int, read: Read = _read_local):
    """The tail both match routes share.  At K > 1 with per-k tables, a
    per-k table that spilled makes its batch's intersection inexact: one
    read of every batch's spill count, and the batches that spilled group
    again as merged K-wide rows (regroup: the route's batch step), which
    give the tables of the JAX engine's whole-run merged rerun; a batch
    keeps its per-k spill count and takes the rerun's candidate_spilled
    (its other stats are the sketch's, the same either way).  Then every
    group's tables in order, n_padded, and the stats summed on the device."""
    if len(index.kmer_lengths) > 1 and config.match_per_k_tables:
        where = [(g, b) for g in groups for b in range(len(g.inputs))]
        spilled = read(torch.cat([g.stats[:, _SPILLED_PER_K] for g in groups]), len(where))
        merged = dataclasses.replace(config, match_per_k_tables=False)
        for i in np.flatnonzero(spilled):
            g, b = where[i]
            real = g.real(b)
            c, n = (x[:real] for x in g.inputs[b])
            redo = regroup(c, n, index, merged, g.caps)
            g.tables[b, 0, :real], g.tables[b, 1, :real] = redo.tid, redo.score
            g.stats[b, _SPILLED] = redo.stats["candidate_spilled"]
        if any(spilled):
            log.info("per-k candidate tables spilled in %d of %d batches; regrouped them merged",
                     int(np.count_nonzero(spilled)), len(spilled))
    C = config.candidate_capacity
    tid = torch.cat([g.tables[:, 0].reshape(-1, C)[: g.n_rows] for g in groups])
    score = torch.cat([g.tables[:, 1].reshape(-1, C)[: g.n_rows] for g in groups])
    total = torch.stack([g.stats.sum(dim=0) for g in groups]).sum(dim=0)
    return tid, score, n_padded, dict(zip(STAT_KEYS, total.unbind(0)))


def _unpack_runs(flat: torch.Tensor, B: int, caps: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each k's (start, length) [B, S_k] views of a phase-1 row."""
    runs, o = [], 0
    for S in caps:
        runs.append((flat[o : o + B * S].view(B, S), flat[o + B * S : o + 2 * B * S].view(B, S)))
        o += 2 * B * S
    return runs


def match_scan(index: DeviceIndex, codes: torch.Tensor, lengths: np.ndarray, config: QuantConfig, *,
               read: Read = _read_local):
    """match_rows' default route, the counterpart of the JAX package's
    match_scan (sketch_rna_tpu/pipeline.py, one lax.scan a length group
    with no host round trip between batches).  Per length group:

      1. every batch (the last padded to a whole batch with empty reads;
         a group of fewer reads than a batch is one batch of their count
         rounded up to a power of two) is sketched (K1 / K2, or K3 past
         1024 windows) and probed (P),
         and each k's largest per-read event total reduced on the device
         (event_size_tensor); the runs stay on the device;
      2. one host read of every batch's sizes (read(x, n), as in
         rowmatch.event_sizes);
      3. every batch is expanded (E) and grouped at its widths
         (group_runs); a batch with a read past MAX_WIDTH events at some
         k groups in row slices, eagerly (rowmatch.match_runs).

    On a card, steps 1 and 3 replay CUDA graphs kept with the index
    (index.graphs, utils/step_graphs.py), keyed by their static shapes
    and the config fields they read, so a later call captures no key an
    earlier one did.  A batch's rows do not follow a group's exact read
    count, so a key holds from call to call (and from chunk to chunk of a
    stream) while a small group's count moves within a power of two:
    empty reads add no events and no candidates, and their rows are
    dropped.  A group whose sketch takes K3 runs step 1 eagerly
    (K3 reads its kept count to the host).  The per-k spill
    regroup and the tables' assembly are match_rows' (_match_tables, with
    sketch_match_step as the regroup).  Tables, row order, the padded
    count and stats equal the per-batch route's (match_rows with
    sketch_match_step) exactly.

    On the open timer (utils/timing.py; a quant call's, or one a tool
    opens around this call) it counts match.groups (in _groups),
    match.host_reads (each default read, and K3's kept-width reads) and
    its graphs' captures; a group that takes K3 adds its batches to
    match.eager_batches and its phase 1's host seconds to the span
    match.eager_sketch (no device sync of its own: K3 syncs each batch).
    Both are declared, so they read 0 where no group takes K3.  Each batch
    that the kernel G groups whole (group_kernel_takes at its widths; a
    graph replay never enters G's wrapper) adds one to
    match.group_kernel_batches, declared too.
    """
    ks = tuple(index.kmer_lengths)
    K = len(ks)
    B, C = config.batch_size, config.candidate_capacity
    # What the captured steps read of the config (batch_size through Bg).
    fields = (config.sketch_fraction, config.chain_fraction, C, config.match_per_k_tables)
    groups: List[_Group] = []
    n_padded = 0
    count("match.eager_batches", 0)
    count("match.group_kernel_batches", 0)
    declare("match.eager_sketch")

    def sketch_probe(c, n, caps):
        sketches = sketch_reads(c, n, ks, config.sketch_fraction, caps)
        runs = [probe_index(h, m, index.per_k[k]) for (h, m, _), k in zip(sketches, ks)]
        overflow = sum(ov for _, _, ov in sketches).to(torch.int64).reshape(1)
        return torch.cat([x.reshape(-1) for run in runs for x in run]
                         + [event_size_tensor([length for _, length in runs]), overflow])

    def with_sketch_stats(res, flat):
        res.stats["sketch_overflow"] = flat[-1]
        res.stats["expand_dropped"] = torch.zeros((), dtype=torch.int64, device=flat.device)
        return res

    def expand_group(flat, rows, caps, widths):
        res = with_sketch_stats(group_runs(_unpack_runs(flat, rows, caps), widths, index, config), flat)
        return torch.stack([res.tid, res.score]), _stat_row(res.stats)

    with StepGraphs(index.device, index.graphs) as graphs:
        for n_rows, l_eff, group, group_lengths, caps in _groups(index, codes, np.asarray(lengths), config):
            n_padded += _round_up(n_rows, B)
            # A small group's batch: its read count rounded up to a power of
            # two, so its keys take a few shapes, not one a count.
            Bg = min(B, pow2ceil(n_rows))
            inputs = list(zip(group.split(Bg), group_lengths.split(Bg)))
            if n_rows % Bg:  # the last batch, padded with empty reads: the same shapes as the rest
                c, n = inputs[-1]
                inputs[-1] = (torch.nn.functional.pad(c, (0, 0, 0, Bg - c.shape[0])),
                              torch.nn.functional.pad(n, (0, Bg - n.shape[0])))
            g = _Group.alloc(n_rows, Bg, caps, inputs, C, index.device)
            groups.append(g)
            # Phase 1: sketch + probe + event sizes, every batch, into one
            # [nb, F] table.  K3 reads its kept count to the host, so a group
            # that takes it runs eagerly.
            runs = torch.empty((len(inputs), 2 * Bg * sum(caps) + K + 1), dtype=torch.int64, device=index.device)
            fn = functools.partial(sketch_probe, caps=caps)
            if sum(map(len, fused_groups(l_eff, ks))) == K:
                for row, (c, n) in zip(runs.unbind(0), inputs):
                    row.copy_(graphs.run(("sketch", Bg, l_eff, caps, fields), fn, c, n))
            else:
                with phase("match.eager_sketch", inner=True):
                    for row, (c, n) in zip(runs.unbind(0), inputs):
                        row.copy_(fn(c, n))
                count("match.eager_batches", len(inputs))
            # One host read of every batch's sizes.
            o = 2 * Bg * sum(caps)
            most_all = read(runs[:, o : o + K].reshape(-1), len(inputs) * K)
            # Phase 2: expand + group at each batch's widths.
            for b, (row, table, stat) in enumerate(zip(runs.unbind(0), g.tables.unbind(0), g.stats.unbind(0))):
                most = most_all[b * K : (b + 1) * K]
                if max(most) <= MAX_WIDTH:
                    if _group_kernel_batch(most, index, config):
                        count("match.group_kernel_batches")
                    widths = tuple(expand_width(m) for m in most)
                    t, st = graphs.run(("group", Bg, caps, widths, fields),
                                       functools.partial(expand_group, rows=Bg, caps=caps, widths=widths), row)
                    table.copy_(t)
                    stat.copy_(st)
                    continue
                # A read past K4's widest row: row slices, eagerly, over the real reads.
                real = g.real(b)
                part = [(start[:real], length[:real]) for start, length in _unpack_runs(row, Bg, caps)]
                g.put(b, with_sketch_stats(match_runs(part, B, _grouper(index, config), read, sizes=list(most)), row))
            del runs
    return _match_tables(groups, index, config, sketch_match_step, n_padded, read)


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
              num_mapped: int, stats: Dict[str, int], group=None) -> QuantResult:
    """EM (with checkpoints) + soft assignment over weighted tables, the
    span em_assign; the QuantResult of every engine.  The route
    (em/em.py em_route: segsum on a card by default) is resolved once,
    and a segsum plan built once, over this process's tables; the
    counter em.segsum_sums starts at 0, so the scatter route reads 0.
    group: the data group whose ranks each hold a share of the classes
    (em/em.py); num_reads and num_mapped are then the global counts."""
    with phase("em_assign"):
        count("em.segsum_sums", 0)
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
        return QuantResult(
            names=list(names),
            pi=pi.cpu().numpy(),
            weighted_counts=weighted.cpu().numpy(),
            has_entry=has_entry.cpu().numpy(),
            em_iterations=iterations,
            num_reads=num_reads,
            num_mapped=num_mapped,
            stats=stats,
            lengths=np.asarray(index.lengths),
        )


def streams(num_reads: int, config: QuantConfig) -> bool:
    """Does quantify stream this many reads (past the fused bound)?"""
    return _round_up(num_reads, config.batch_size) > FUSED_MAX_PADDED_READS


@quant_call
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
    (utils/profiling.py), the stage spans as "srt.<stage>" records.
    """
    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    R = packed.num_reads
    if R == 0:
        return _empty_result(index)
    if streams(R, config):
        from sketch_rna_tpu_torch.stream import quantify_streamed

        with maybe_trace("quant_streamed"):
            return quantify_streamed(index, packed, config)
    # No profiler record: it would cover the idle gaps between the stages' records.
    with maybe_trace("quant_fused"), phase("quant_fused", items=R, device=index.device, record=False):
        return _quantify_fused(index, packed, config)


def _quantify_fused(index: DeviceIndex, packed: PackedReads, config: QuantConfig) -> QuantResult:
    """The fused engine: every read's candidate table on the device at once."""
    R = packed.num_reads
    T = index.num_transcripts
    dev = index.device

    with phase("match"):
        tbl_tid, tbl_score, n_padded, stats = match_rows(index, torch.from_numpy(packed.codes), packed.lengths,
                                                         config)
        host_stats = dict(zip(stats, host_read(torch.stack(list(stats.values())))))
        for key in LOSS_KEYS:
            if host_stats[key]:
                log.warning("capacity overflow during matching: %s=%d", key, host_stats[key])

    with phase("classes", device=dev):
        # Rows are rank-ordered, so narrowing to the widest candidate set
        # (pow2) is lossless.
        n_cand = (tbl_score > 0).sum(dim=1)
        n_cand_max, num_mapped = (int(v) for v in torch.stack([n_cand.max(), (n_cand > 0).sum()]).tolist())
        W = min(pow2ceil(max(n_cand_max, 1)), config.candidate_capacity)
        tbl_tid = tbl_tid[:, :W]
        tbl_score = tbl_score[:, :W]
        tables, static_base, static_has = em_tables(tbl_tid, tbl_score, config, num_transcripts=T, n_rows=n_padded)

    result = em_assign(tables, static_base, static_has, index, config, num_reads=R, num_mapped=num_mapped,
                       stats=host_stats)
    result.timing["index_upload"] = index.upload_s
    return result


@quant_call
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
