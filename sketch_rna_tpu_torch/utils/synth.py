"""Synthetic transcriptomes and reads (numpy, seeded).

synth_transcriptome is the JAX package's generator (same numbers for the
same Generator state).  sample_reads draws reads with numpy instead of
jax.random, so any machine with numpy can make the data.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def synth_transcriptome(
    rng: np.random.Generator,
    n: int,
    len_lo: int = 600,
    len_hi: int = 2500,
    iso_frac: float = 0.6,
) -> List[np.ndarray]:
    """Isoform families sharing long exact stretches: a random base
    transcript, then with probability iso_frac per step an isoform that
    skips a middle segment and gains a 50-base tail."""
    seqs: List[np.ndarray] = []
    while len(seqs) < n:
        ln = int(rng.integers(len_lo, len_hi))
        base = rng.integers(0, 4, size=ln).astype(np.uint8)
        seqs.append(base)
        while len(seqs) < n and rng.random() < iso_frac:
            a = int(rng.integers(0, ln // 3))
            b = int(rng.integers(a, ln))
            iso = np.concatenate(
                [base[:a], base[b:], rng.integers(0, 4, size=50).astype(np.uint8)]
            )
            if iso.size >= 100:
                seqs.append(iso.astype(np.uint8))
    return seqs[:n]


def sample_reads(
    seqs: List[np.ndarray],
    n_reads: int,
    read_len: int,
    pad_len: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Error-free reads: a uniform transcript, a uniform start, read_len
    bases (fewer for a shorter transcript).

    Returns (codes [n_reads, pad_len] uint8 zero-padded, lengths [n_reads]
    int32).
    """
    if pad_len < read_len:
        raise ValueError(f"pad_len {pad_len} < read_len {read_len}")
    rng = np.random.default_rng(seed)
    lens = np.array([s.size for s in seqs], dtype=np.int64)
    offs = np.zeros(lens.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    # read_len trailing zeros: every window below starts inside `big`.
    big = np.concatenate(list(seqs) + [np.zeros(read_len, np.uint8)])
    tid = rng.integers(0, lens.size, size=n_reads)
    span = np.maximum(lens[tid] - read_len, 0)
    start = offs[tid] + (rng.random(n_reads) * (span + 1)).astype(np.int64)
    eff = np.minimum(lens[tid], read_len).astype(np.int32)
    windows = np.lib.stride_tricks.sliding_window_view(big, read_len)
    codes = np.zeros((n_reads, pad_len), dtype=np.uint8)
    codes[:, :read_len] = windows[start]
    codes[:, :read_len][np.arange(read_len)[None, :] >= eff[:, None]] = 0
    return codes, eff
