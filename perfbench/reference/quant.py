"""The benchmark's plain reference: the upstream tool's quant semantics in
vectorised PyTorch, on any device.

It follows the scalar oracle (reference/oracle.py, a frozen copy of the
port's oracle/reference_oracle.py), which tests hold it to:

  - the forward ntHash2 of every k-mer, low 32 bits (src/sketch.cpp:31-37),
    as a windowed XOR of rotated seeds; a k-mer is kept iff its hash is at
    most (uint32)(UINT32_MAX * float(fraction)) (src/sketch.cpp:24-39), and
    a sketch is a set;
  - the index: per k, each kept hash -> the ascending transcripts whose
    sketch holds it; transcripts shorter than the largest k are not
    sketched (src/main.cpp:66-75);
  - sparse chaining (src/sparse_chaining.cpp:29-115): per read and k the
    transcripts' shared-hash counts, a transcript a candidate iff at every
    k its count is not below chain_fraction x that k's largest count, its
    score the sum of its counts;
  - the EM (src/isoform_assignment.cpp:9-68) in float64 with the
    reference's unnormalised M-step, and the soft assignment (:70-97).

It imports nothing of the port, of JAX or of the JAX package, and takes
nothing the port made: it builds its own index from the transcriptome's
codes and sketches the reads itself.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# Published ntHash per-base seeds (ntHash kmer.hpp: seed_a..seed_t), in
# the 2-bit code order A=0, C=1, G=2, T=3.
SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456)
_TID_BITS = 31
# Windows hashed at once in the index build, reads at once in chaining.
INDEX_CHUNK = 1 << 24
READ_BLOCK = 1 << 18

Index = Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # k -> keys, row_ptr, postings (int64)


def srol(x: int, d: int) -> int:
    """ntHash2's split rotation left by d: the 33-bit low field and the
    31-bit high field rotate on their own."""
    d33, d31 = d % 33, d % 31
    lo, hi = x & ((1 << 33) - 1), (x >> 33) & ((1 << 31) - 1)
    if d33:
        lo = ((lo << d33) | (lo >> (33 - d33))) & ((1 << 33) - 1)
    if d31:
        hi = ((hi << d31) | (hi >> (31 - d31))) & ((1 << 31) - 1)
    return (hi << 33) | lo


def threshold(fraction: float) -> int:
    """(uint32_t)(UINT32_MAX * fraction), the fraction a C float widened to
    double (the upstream global sketch_size is a float)."""
    return int(float(np.float64(0xFFFFFFFF) * np.float64(np.float32(fraction))))


def window_table(k: int, device) -> torch.Tensor:
    """[k, 4] int64: the low 32 bits of srol^(k-1-j)(seed[b])."""
    t = [[srol(SEEDS[b], k - 1 - j) & 0xFFFFFFFF for b in range(4)] for j in range(k)]
    return torch.tensor(t, dtype=torch.int64, device=device)


def window_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[n, L-k+1] int64 low-32-bit hashes of every window of [n, L] codes."""
    n, L = codes.shape
    nw = L - k + 1
    table = window_table(k, codes.device)
    c = codes.long()
    h = torch.zeros((n, max(nw, 0)), dtype=torch.int64, device=codes.device)
    for j in range(k):
        h ^= table[j][c[:, j : j + nw]]
    return h


def build_index(flat: torch.Tensor, lengths: torch.Tensor, ks: Sequence[int], fraction: float) -> Index:
    """Each k's CSR index (keys, row_ptr, postings) of the transcripts
    whose codes lie back to back in flat [M] uint8, lengths [T]."""
    dev = flat.device
    lengths = lengths.to(dev, torch.int64)
    ends = torch.cumsum(lengths, 0)
    sketchable = lengths >= max(ks)
    thr = threshold(fraction)
    M = flat.numel()
    out: Index = {}
    for k in ks:
        pairs = []
        for p0 in range(0, max(M - k + 1, 0), INDEX_CHUNK):
            p1 = min(p0 + INDEX_CHUNK, M - k + 1)
            h = window_hashes(flat[p0 : p1 + k - 1][None, :], k)[0]
            pos = torch.arange(p0, p1, device=dev)
            owner = torch.searchsorted(ends, pos, right=True)
            ok = (h <= thr) & (pos + k <= ends[owner]) & sketchable[owner]
            pairs.append((h[ok] << _TID_BITS) | owner[ok])
        pair = torch.unique(torch.cat(pairs)) if pairs else torch.zeros(0, dtype=torch.int64, device=dev)
        keys, counts = torch.unique_consecutive(pair >> _TID_BITS, return_counts=True)
        row_ptr = torch.zeros(keys.numel() + 1, dtype=torch.int64, device=dev)
        row_ptr[1:] = torch.cumsum(counts, 0)
        out[k] = (keys, row_ptr, pair & ((1 << _TID_BITS) - 1))
    return out


def index_digest(keys, row_ptr, postings) -> str:
    """sha256 over keys (uint32) | row_ptr (int32) | postings (int32),
    little-endian: the digest a configuration file freezes."""
    h = hashlib.sha256()
    for a, dtype in ((keys, "<u4"), (row_ptr, "<i4"), (postings, "<i4")):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a.astype(dtype)).tobytes())
    return h.hexdigest()


def read_sketches(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                  fraction: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(read row, hash) of every distinct kept hash of each of [n, L]
    reads at k (a read's sketch is a set), ascending by read."""
    dev = codes.device
    if codes.shape[1] < k:
        return torch.zeros(0, dtype=torch.int64, device=dev), torch.zeros(0, dtype=torch.int64, device=dev)
    h = window_hashes(codes, k)
    win = torch.arange(h.shape[1], device=dev)
    keep = (win[None, :] < (lengths.long()[:, None] - k + 1)) & (h <= threshold(fraction))
    rows = torch.arange(codes.shape[0], device=dev)[:, None].expand_as(h)
    distinct = torch.unique((rows[keep] << 32) | h[keep])
    return distinct >> 32, distinct & 0xFFFFFFFF


def _read_counts(codes: torch.Tensor, lengths: torch.Tensor, index: Index, k: int, fraction: float,
                 T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(read * T + tid, shared-hash count) of every pair of read and
    transcript sharing a sketch hash at k, for [n, L] reads."""
    dev = codes.device
    keys, row_ptr, postings = index[k]
    read, hsh = read_sketches(codes, lengths, k, fraction)
    at = torch.searchsorted(keys, hsh).clamp_(max=max(keys.numel() - 1, 0))
    hit = (keys[at] == hsh) if keys.numel() else torch.zeros_like(hsh, dtype=torch.bool)
    read, at = read[hit], at[hit]
    start, count = row_ptr[at], row_ptr[at + 1] - row_ptr[at]
    ev_read = torch.repeat_interleave(read, count)
    first = torch.cumsum(count, 0) - count
    ev_pos = torch.repeat_interleave(start - first, count) + torch.arange(ev_read.numel(), device=dev)
    return torch.unique(ev_read * T + postings[ev_pos], return_counts=True)


def chain(codes: torch.Tensor, lengths: torch.Tensor, index: Index, ks: Sequence[int], fraction: float,
          chain_fraction: float, T: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every candidate (read row, tid, score) of [n, L] reads."""
    dev = codes.device
    per_k = [_read_counts(codes, lengths, index, k, fraction, T) for k in ks]
    pair = torch.unique(torch.cat([p for p, _ in per_k]))
    counts = []
    for p, c in per_k:
        full = torch.zeros(pair.numel(), dtype=torch.int64, device=dev)
        full[torch.searchsorted(pair, p)] = c
        counts.append(full)
    read, tid = pair // T, pair % T
    ok = torch.ones(pair.numel(), dtype=torch.bool, device=dev)
    for c in counts:
        most = torch.zeros(codes.shape[0], dtype=torch.int64, device=dev).scatter_reduce_(0, read, c, "amax")
        ok &= ~(c.double() < chain_fraction * most.double()[read])
    score = torch.stack(counts).sum(dim=0) if counts else torch.zeros_like(pair)
    return read[ok], tid[ok], score[ok]


def em(read: torch.Tensor, tid: torch.Tensor, score: torch.Tensor, num_reads: int, T: int,
       max_iterations: int = 20, convergence: float = 0.01, pseudocount: float = 0.01,
       epsilon: float = 1e-10) -> Tuple[torch.Tensor, int]:
    """The upstream EM over candidate pairs; returns (pi [T], iterations).
    num_reads: R, every valid read, mapped or not."""
    dev, dtype = read.device, torch.float64
    pi = torch.full((T,), 1.0 / T, dtype=dtype, device=dev)
    s = score.to(dtype)
    pc32 = np.float32(pseudocount)
    term = float(np.float32(pc32 / np.float32(num_reads)))
    it = 0
    for it in range(1, max_iterations + 1):
        v = pi[tid] * s
        den = torch.zeros(num_reads, dtype=dtype, device=dev).index_add_(0, read, v)[read]
        post = torch.where(den > epsilon, v * (1.0 / den), torch.zeros_like(v))
        new_pi = (torch.zeros(T, dtype=dtype, device=dev).index_add_(0, tid, post) + term) + float(pc32)
        change = float(torch.abs(new_pi - pi).sum())
        pi = new_pi
        if change < convergence:
            break
    return pi, it


def assign(read: torch.Tensor, tid: torch.Tensor, score: torch.Tensor, pi: torch.Tensor, num_reads: int):
    """(weighted counts [T], has_entry [T] bool): each read's unit of
    weight shared out by pi[t] x score; a transcript has a CSV row iff it
    is a candidate of a read whose total is above 0."""
    T = pi.numel()
    v = pi[tid] * score.to(pi.dtype)
    total = torch.zeros(num_reads, dtype=pi.dtype, device=pi.device).index_add_(0, read, v)[read]
    live = total > 0
    weighted = torch.zeros(T, dtype=pi.dtype, device=pi.device).index_add_(0, tid[live], v[live] / total[live])
    has_entry = torch.zeros(T, dtype=torch.bool, device=pi.device)
    has_entry[tid[live]] = True
    return weighted, has_entry


def quant(codes, lengths, index: Index, T: int, q: Dict, device) -> Dict:
    """The reference's quant of one sample: codes [N, L] uint8 and
    lengths [N] (numpy or torch), index from build_index, q the
    configuration's "quant" settings.  Reads go through chaining in
    blocks of READ_BLOCK.  Returns pi, weighted_counts, has_entry (numpy)
    and num_mapped, em_iterations."""
    ks = tuple(q["kmer_lengths"])
    N = int(lengths.shape[0])
    parts = []
    for r0 in range(0, N, READ_BLOCK):
        c = torch.as_tensor(codes[r0 : r0 + READ_BLOCK]).to(device)
        n = torch.as_tensor(lengths[r0 : r0 + READ_BLOCK]).to(device)
        width = min(c.shape[1], max(int(n.max()), max(ks)) if n.numel() else c.shape[1])
        read, tid, score = chain(c[:, :width], n, index, ks, q["sketch_fraction"], q["chain_fraction"], T)
        parts.append((read + r0, tid, score))
    read, tid, score = (torch.cat(x) for x in zip(*parts))
    pi, iterations = em(read, tid, score, N, T, q["em_max_iterations"], q["em_convergence"])
    weighted, has_entry = assign(read, tid, score, pi, N)
    return {"pi": pi.cpu().numpy(), "weighted_counts": weighted.cpu().numpy(),
            "has_entry": has_entry.cpu().numpy(), "num_mapped": int(torch.unique(read).numel()),
            "em_iterations": iterations}
