"""Synthetic transcriptomes and reads (numpy, seeded).

synth_transcriptome is the JAX package's generator (same numbers for the
same Generator state).  sample_reads draws reads with numpy instead of
jax.random, so any machine with numpy can make the data.  fastq_records
and write_fastq frame reads as FASTQ text with vectorised numpy (no
per-read Python), as scripts/make_fastq.py's frame_fastq_chunk does.
GENCODE_* name the GENCODE-scale transcriptome of the scale tooling
(scripts/scale_check_torch.py, scripts/make_fastq_torch.py, chip_smoke.py's
gencode phase) and the index it must give.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sketch_rna_tpu_torch.io.fasta import FastaRecords

# synth_transcriptome(default_rng(GENCODE_SEED), GENCODE_TRANSCRIPTS):
# 298.5 Mbases, about the size of the human transcriptome (the JAX
# repo's scripts/scale_check.py and bench.py's c4_gencode_* entries).
GENCODE_SEED = 2026
GENCODE_TRANSCRIPTS = 250_000
# Per k: (keys, postings, sha256 over keys | row_ptr | postings, as
# KIndex.sha256 takes it) of the JAX package's build_index
# (sketch_rna_tpu/index/build.py) on fasta_records of that transcriptome
# at the default sketch fraction, computed on the CPU with JAX at ks
# (21, 31); its k = 31 part equals the k = 31 build's.
# tests/test_torch_index.py rebuilds them with the JAX package.
GENCODE_INDEX = {
    21: (8_047_904, 14_679_988, "81365fb815ac1efe871bb22892c3f0067c114ead2b15147c335aaee0b6010c51"),
    31: (8_061_137, 14_545_110, "66fdfbbc379417a6a1e091089d62b65b4ba3f5ed54211c91022c33dc65c86b03"),
}


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


def gencode_transcriptome(n: int = GENCODE_TRANSCRIPTS) -> List[np.ndarray]:
    """The first n transcripts of the GENCODE-scale transcriptome."""
    return synth_transcriptome(np.random.default_rng(GENCODE_SEED), n)


def fasta_records(seqs: List[np.ndarray], prefix: str = "T", width: int = 6) -> FastaRecords:
    """FastaRecords of 2-bit sequences named prefix + a zero-padded
    index: T000000, T000001, ..."""
    text = [_BASES[s].tobytes().decode() for s in seqs]
    return FastaRecords([f"{prefix}{i:0{width}d}" for i in range(len(seqs))], text, 0)


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


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_ID_DIGITS = 10


def fastq_records(codes: np.ndarray, lengths: np.ndarray, start_id: int = 0) -> bytes:
    """FASTQ text of reads [n, L] uint8 base codes with lengths [n]: per
    read "@r" + its 10-digit id (start_id, start_id + 1, ...), the
    read's first length bases, "+" and a quality line of "I" as long."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths, dtype=np.int64)
    n = codes.shape[0]
    L = int(lengths.max()) if n else 0
    head = 2 + _ID_DIGITS + 1
    rec = np.empty((n, head + L + 3 + L + 1), dtype=np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    ids = np.arange(start_id, start_id + n, dtype=np.int64)
    for d in range(_ID_DIGITS):
        rec[:, 2 + d] = (ids // 10 ** (_ID_DIGITS - 1 - d)) % 10 + ord("0")
    rec[:, head - 1] = ord("\n")
    rec[:, head : head + L] = _BASES[codes[:, :L]]
    rec[:, head + L : head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + L + 3 : head + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    # A read shorter than L (rare: a transcript that short) is framed on
    # its own at its length; the rows between such reads go out whole.
    parts, prev = [], 0
    for i in np.flatnonzero(lengths < L):
        n_i = int(lengths[i])
        parts += [rec[prev:i].tobytes(), rec[i, : head + n_i].tobytes(), b"\n+\n", b"I" * n_i, b"\n"]
        prev = i + 1
    parts.append(rec[prev:].tobytes())
    return b"".join(parts)


def write_fastq(path: str, codes: np.ndarray, lengths: np.ndarray, start_id: int = 0, append: bool = False) -> int:
    """Write (or append) reads as FASTQ records (fastq_records), framing
    2^20 reads at a time; returns the bytes written."""
    written, chunk = 0, 1 << 20
    with open(path, "ab" if append else "wb") as fh:
        for r0 in range(0, codes.shape[0], chunk):
            data = fastq_records(codes[r0 : r0 + chunk], lengths[r0 : r0 + chunk], start_id + r0)
            fh.write(data)
            written += len(data)
    return written
