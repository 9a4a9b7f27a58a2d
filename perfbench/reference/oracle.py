"""A frozen copy of the port's scalar oracle, sketch_rna_tpu_torch/
oracle/reference_oracle.py, with the scalar ntHash and sketch it calls
(hash/nthash.py nthash_forward_scalar, sketch/fracminhash.py
sketch_scalar and fracminhash_threshold): the upstream tool's math one
k-mer and one read at a time, in float64.  The benchmark's tests hold the
vectorised reference (quant.py) to it; nothing on a run's path calls it.
It imports neither the port nor JAX.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# Published ntHash per-base seeds (ntHash kmer.hpp: seed_a..seed_t).
# Base code order matches the 2-bit codes: A=0, C=1, G=2, T=3.
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
NTHASH_SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T)

_MASK33 = (1 << 33) - 1
_MASK31 = (1 << 31) - 1


def srol(x: int, d: int = 1) -> int:
    """ntHash2 split-rotate-left by d: independent rotations of the
    33-bit low field (bits 0..32) and the 31-bit high field (bits 33..63)."""
    d33 = d % 33
    d31 = d % 31
    lo = x & _MASK33
    hi = (x >> 33) & _MASK31
    if d33:
        lo = ((lo << d33) | (lo >> (33 - d33))) & _MASK33
    if d31:
        hi = ((hi << d31) | (hi >> (31 - d31))) & _MASK31
    return (hi << 33) | lo


def nthash_forward_scalar(codes: Sequence[int], k: int) -> List[int]:
    """64-bit forward hashes of every k-mer by the published rolling
    recurrence, fh(i+1) = srol(fh(i)) ^ srol^k(seed[s_i]) ^ seed[s_(i+k)]
    (nthash::NtHash roll / get_forward_hash, src/sketch.cpp:31-36)."""
    n = len(codes)
    if n < k:
        return []
    h = 0
    for j in range(k):
        h = srol(h, 1) ^ NTHASH_SEEDS[codes[j]]
    out = [h]
    for i in range(1, n - k + 1):
        h = srol(h, 1) ^ srol(NTHASH_SEEDS[codes[i - 1]], k) ^ NTHASH_SEEDS[codes[i + k - 1]]
        out.append(h)
    return out


def fracminhash_threshold(fraction: float) -> int:
    """uint32 keep-threshold with the reference's C-cast truncation
    (src/sketch.cpp:25-26): static_cast<uint32_t>(UINT32_MAX * fraction).

    The reference stores the fraction in a `float` (global sketch_size =
    0.05f, src/main.cpp:43) that widens to the `double` parameter, so
    the product uses double(float(fraction)) — e.g. 0.05 yields
    214748367, not 214748364.  Promote through float32 to match the
    binary bit-for-bit."""
    if not (0.0 <= fraction < 1.0):
        raise ValueError("fraction must be in [0, 1) — 1.0 would collide with the pad sentinel")
    f = np.float64(np.float32(fraction))  # float -> double, like the C++ call
    return int(float(np.float64(0xFFFFFFFF) * f))  # truncates


def sketch_scalar(codes, k: int, fraction: float) -> set:
    """The reference's sketch of one sequence as a Python set of the kept
    low-32-bit hashes, one k-mer at a time: the reference oracle's
    (oracle/reference_oracle.py), independent of every batched path."""
    thr = fracminhash_threshold(fraction)
    out = set()
    for h in nthash_forward_scalar(list(codes), k):
        h32 = h & 0xFFFFFFFF
        if h32 <= thr:
            out.add(h32)
    return out


Segments = Dict[str, List[Tuple[int, int]]]  # read_id -> [(tid, score)]


def oracle_build_index(
    seq_codes: Sequence[np.ndarray],
    kmer_lengths: Sequence[int],
    fraction: float,
) -> Dict[int, Dict[int, List[int]]]:
    """k -> hash -> [tid] (sorted), mirroring build_kmer_to_transcript_map
    (src/sketch.cpp:51-74) with the short-transcript skip
    (src/main.cpp:66-75)."""
    max_k = max(kmer_lengths)
    out: Dict[int, Dict[int, List[int]]] = {k: {} for k in kmer_lengths}
    for tid, codes in enumerate(seq_codes):
        if len(codes) < max_k:
            continue
        for k in kmer_lengths:
            for h in sorted(sketch_scalar(codes, k, fraction)):
                out[k].setdefault(h, []).append(tid)
    return out


def oracle_sparse_chain(
    read_sketches: Dict[str, Dict[int, set]],
    index: Dict[int, Dict[int, List[int]]],
    kmer_lengths: Sequence[int],
    fraction: float,
) -> Segments:
    """sparse_chain (src/sparse_chaining.cpp:29-115): per-k shared-hash
    counting, per-k max, forall-k fractional threshold, score = sum of
    counts, sorted descending (tie-break tid asc for determinism)."""
    segments: Segments = {}
    nk = len(kmer_lengths)
    for read_id, sketches in read_sketches.items():
        match_counts: Dict[int, List[int]] = {}
        for i, k in enumerate(kmer_lengths):
            mapping = index.get(k)
            sk = sketches.get(k)
            if mapping is None or sk is None:
                continue
            for h in sk:
                for tid in mapping.get(h, ()):
                    if tid not in match_counts:
                        match_counts[tid] = [0] * nk
                    match_counts[tid][i] += 1
        max_counts = [0] * nk
        for counts in match_counts.values():
            for i, c in enumerate(counts):
                if c > max_counts[i]:
                    max_counts[i] = c
        thresholds = [fraction * m for m in max_counts]  # float64, like C++
        candidates: List[Tuple[int, int]] = []
        for tid, counts in match_counts.items():
            ok = True
            score = 0
            for i, c in enumerate(counts):
                if c < thresholds[i]:
                    ok = False
                    break
                score += c
            if ok:
                candidates.append((tid, score))
        candidates.sort(key=lambda p: (-p[1], p[0]))
        segments[read_id] = candidates
    return segments


def oracle_em(
    segments: Segments,
    num_transcripts: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
) -> np.ndarray:
    """estimate_isoform_abundance_em (src/isoform_assignment.cpp:9-68),
    float64 throughout; returns pi as a dense [T] array."""
    T = num_transcripts
    pi = np.full(T, 1.0 / T, dtype=np.float64)
    R = len(segments)
    for _ in range(max_iterations):
        posterior_sums = np.zeros(T, dtype=np.float64)
        for candidates in segments.values():
            denominator = 0.0
            numerators = []
            for tid, match_count in candidates:
                v = pi[tid] * float(match_count)
                numerators.append(v)
                denominator += v
            if denominator > epsilon:
                inv = 1.0 / denominator
                for (tid, _), num in zip(candidates, numerators):
                    posterior_sums[tid] += num * inv
        # C++: float pseudocount = 0.01;  new_pi = ps + pseudocount/R + pseudocount
        # 'pseudocount / R' divides in float32 (size_t converts to float),
        # then each addition promotes to double, left to right.
        pc32 = np.float32(pseudocount)
        term = np.float64(np.float32(pc32 / np.float32(R)))
        new_pi = (posterior_sums + term) + np.float64(pc32)
        total_change = float(np.sum(np.abs(new_pi - pi)))
        pi = new_pi
        if total_change < convergence_threshold:
            break
    return pi


def oracle_assign(segments: Segments, pi: np.ndarray) -> np.ndarray:
    """assign_reads_to_isoforms (src/isoform_assignment.cpp:70-97):
    weighted[t] accumulates pi[t]*count / sum over candidates; returns a
    dense [T] array plus implicit membership: entries for transcripts that
    were never a candidate stay exactly 0 and correspond to 'no entry'."""
    weighted = np.zeros(pi.shape[0], dtype=np.float64)
    for candidates in segments.values():
        total = 0.0
        for tid, match_count in candidates:
            total += pi[tid] * float(match_count)
        if total > 0.0:
            for tid, match_count in candidates:
                weighted[tid] += (pi[tid] * float(match_count)) / total
    return weighted


def oracle_quant(
    seq_codes: Sequence[np.ndarray],
    read_codes: Dict[str, np.ndarray],
    kmer_lengths: Sequence[int],
    sketch_fraction: float = 0.05,
    chain_fraction: float = 0.9,
    em_max_iterations: int = 20,
    em_convergence: float = 0.01,
) -> Tuple[Segments, np.ndarray, np.ndarray, List[int]]:
    """End-to-end scalar quant on pre-validated, pre-filtered inputs.

    read_codes must already exclude invalid / too-short reads
    (src/main.cpp:131-138).  Returns (segments, pi, weighted_counts,
    csv_tids) where csv_tids lists transcripts present in both
    read_counts and pi — i.e. transcripts that were a candidate of at
    least one read with positive denominator (src/data_io.cpp:143-147).
    """
    index = oracle_build_index(seq_codes, kmer_lengths, sketch_fraction)
    read_sketches = {
        rid: {k: sketch_scalar(codes, k, sketch_fraction) for k in kmer_lengths}
        for rid, codes in read_codes.items()
    }
    segments = oracle_sparse_chain(read_sketches, index, kmer_lengths, chain_fraction)
    pi = oracle_em(segments, len(seq_codes), em_max_iterations, em_convergence)
    weighted = oracle_assign(segments, pi)
    # read_counts gets an entry for a tid iff some read had total>0 and the
    # tid was among its candidates (entry may be created by += even when
    # the added probability is 0, which cannot happen here since pi>0 and
    # count>=1).
    has_entry = np.zeros(len(seq_codes), dtype=bool)
    for candidates in segments.values():
        total = sum(pi[tid] * float(c) for tid, c in candidates)
        if total > 0.0:
            for tid, _ in candidates:
                has_entry[tid] = True
    csv_tids = [t for t in range(len(seq_codes)) if has_entry[t]]
    return segments, pi, weighted, csv_tids
