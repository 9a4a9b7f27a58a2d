"""Configuration for the quantification pipeline.

The reference constants keep the reference's exact defaults:

  sketch_fraction   = 0.05   (src/main.cpp:43, global `sketch_size`)
  chain_fraction    = 0.9    (src/main.cpp:185, `sparse_chain(..., 0.9)`)
  em_max_iterations = 20     (src/main.cpp:188)
  em_convergence    = 0.01   (src/main.cpp:188)
  pseudocount       = 0.01   (src/isoform_assignment.cpp:54)
  em_epsilon        = 1e-10  (src/isoform_assignment.cpp:28)
  kmer_lengths      = (31,)  (src/main.cpp:215 default)

The capacity knobs bound fixed-width device rows; anything past a
capacity is counted and reported, never silent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    # --- reference-mirrored algorithm constants -------------------------
    kmer_lengths: Tuple[int, ...] = (31,)
    sketch_fraction: float = 0.05
    chain_fraction: float = 0.9
    em_max_iterations: int = 20
    em_convergence: float = 0.01
    pseudocount: float = 0.01
    em_epsilon: float = 1e-10

    # --- capacity / batching knobs ---------------------------------------
    # Reads per device batch through the sketch + match kernels.
    batch_size: int = 8192
    # Minimum padded read length (the CLI pads to at least this).
    max_read_len: int = 256
    # Floor of the per-read sketch capacity (distinct kept hashes).
    sketch_capacity: int = 32
    # Candidate transcripts kept per read, by (score desc, tid asc).
    candidate_capacity: int = 64
    # EM / assignment accumulation dtype: "float64", the default, is the
    # reference's C++ double math (an H100 has native fp64); "float32"
    # lands within ~1e-5 relative of it.
    em_dtype: str = "float64"
    # K > 1 grouping mode: True = per-k top-2C tables intersected (a batch
    # whose per-k table spills is regrouped merged); False = the merged
    # K-wide event grouping for every batch (truncates only the final set).
    match_per_k_tables: bool = True
    # EM routes (em/em.py em_route), "auto" | "on" | "off" as in the JAX
    # package.  em_segsum: the deterministic segmented sum over a plan of
    # transcript-sorted lanes instead of index_add_ ("auto": segsum on a
    # card, the scatter on the CPU).
    # em_mxu: the JAX package's one-hot E-step, which the port does not
    # have: "on" takes the scatter route and, as there, turns segsum off.
    em_mxu: str = "auto"
    em_segsum: str = "auto"
    # Collapse reads with identical candidate profiles into weighted
    # equivalence classes, split into width tiers, before the EM (exact;
    # EM cost then scales with transcriptome ambiguity, not read count).
    # Off, the EM runs over the reads' rows, split into narrow and wide.
    em_equivalence_classes: bool = True
    # Fold single-candidate classes out of the EM loop: their E-step
    # posterior is identically 1, so their posterior-sum contribution is
    # an iteration-invariant constant (em/classes.py tier_partition).
    # Off by itself when em_epsilon could zero a singleton's denominator
    # (pipeline._fold_ok); exact whenever active.
    em_fold_singletons: bool = True

    # --- streaming engine (stream.py), past FUSED_MAX_PADDED_READS --------
    # Rows of the device class buffer: bounds the DISTINCT candidate
    # profiles held on the card at once (transcriptome ambiguity, not
    # read count); a run's known read count bounds it further.
    stream_class_capacity: int = 1 << 23
    # Reads per super-chunk: one host-to-device upload, matched batch by
    # batch and pre-deduplicated into weighted classes.
    stream_chunk_reads: int = 1 << 20
    # Classes with at most this many candidates live in the big buffer at
    # this width (lossless: class rows are rank-ordered); wider ones go to
    # a full-width side buffer.  0 = one full-width buffer.
    stream_narrow_width: int = 16
    # When the buffer cannot take a chunk's classes even after a
    # compaction, drain it to the host and re-merge before the EM (exact).
    # False drops the classes past the buffer, counted in class_overflow.
    stream_drain: bool = True

    # --- EM checkpoint / resume -------------------------------------------
    # Save (pi, iteration) to this path every em_checkpoint_every
    # iterations, and resume from it when it exists.
    em_checkpoint: Optional[str] = None
    em_checkpoint_every: int = 5

    def sketch_capacity_for(self, k: int, read_len: Optional[int] = None) -> int:
        """Auto-size sketch capacity from the padded read length (or an
        explicit per-bucket width)."""
        n_kmers = max((read_len or self.max_read_len) - k + 1, 1)
        expected = n_kmers * self.sketch_fraction
        # ~6 sigma headroom on a binomial tail, rounded up to a multiple
        # of 8; never below the configured floor.
        cap = int(math.ceil(expected + 6.0 * math.sqrt(max(expected, 1.0))))
        cap = ((cap + 7) // 8) * 8
        return max(cap, self.sketch_capacity)
