"""ntHash2 forward k-mer hash (low 32 bits) as a windowed XOR.

The reference uses the forward-strand ntHash2 value truncated to its low
32 bits (src/sketch.cpp:31-37).  The hash of the k-mer at position i is
a pure XOR of per-offset rotated seeds,

    fh(i) = XOR_{j=0..k-1} srol^(k-1-j)( seed[s[i+j]] ),

so a [k, 4] table of the low 32 bits of srol^(k-1-j)(seed_b) evaluates
every window independently: no rolling recurrence, no scan.

Two scalar forms of the full 64-bit hash, the published rolling
recurrence and the direct windowed XOR, are the reference oracle's
(oracle/reference_oracle.py); tests hold them against each other.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

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


def nthash_forward_scalar_direct(codes: Sequence[int], k: int) -> List[int]:
    """The same hashes by the direct windowed XOR, with no rolling state:
    independent of nthash_forward_scalar, which tests hold it against."""
    out = []
    for i in range(len(codes) - k + 1):
        h = 0
        for j in range(k):
            h ^= srol(NTHASH_SEEDS[codes[i + j]], k - 1 - j)
        out.append(h)
    return out


@functools.lru_cache(maxsize=None)
def window_tables_u32(k: int) -> np.ndarray:
    """Low-32-bit rotated-seed table, shape [k, 4] uint32:
    tables[j, b] = low 32 bits of srol^(k-1-j)(seed_b)."""
    t = np.empty((k, 4), dtype=np.uint32)
    for j in range(k):
        for b in range(4):
            t[j, b] = srol(NTHASH_SEEDS[b], k - 1 - j) & 0xFFFFFFFF
    return t


def nthash_batch_u32(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Forward ntHash (low 32 bits) of every window of a padded batch.

    codes: [B, L] integer base codes in {0,1,2,3}.
    Returns [B, L-k+1] int64 holding uint32 values; entry [b, i] hashes
    the k-mer at position i.  Windows that overrun a read's true length
    hash padding — callers mask them.
    """
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    B, L = codes.shape
    nk = L - k + 1
    if nk < 1:
        raise ValueError(f"padded length {L} < k={k}")
    tables = torch.from_numpy(window_tables_u32(k).astype(np.int64)).to(codes.device)
    c = codes.long()
    h = torch.zeros((B, nk), dtype=torch.int64, device=codes.device)
    for j in range(k):
        h ^= tables[j][c[:, j : j + nk]]
    return h


def _rot33(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Rotate the 33-bit values x left by d (0 <= d < 33), elementwise."""
    low = x & ((1 << (33 - d)) - 1)  # the bits that stay inside 33 after the shift
    return (low << d) | (x >> (33 - d))


def nthash_prefix_u32(codes: torch.Tensor, k: int) -> torch.Tensor:
    """nthash_batch_u32 by the O(1)-per-window formulation of the fused
    sketch kernels K1 / K2 (csrc/sketch.cu).

    srol is XOR-linear and srol^-q undoes srol^q, so with the prefix
    P(m) = XOR_{q<m} srol^(-q)(seed[s_q]),

        fh(i) = srol^(k-1+i)( P(i+k) ^ P(i) ).

    The low 32 bits of srol^d(x) depend only on x's 33-bit low field,
    which rotates by d mod 33; so P keeps that field alone, and one
    prefix serves every k.  Nothing on the quant path calls this: it
    pins the kernels' arithmetic to the windowed XOR on the CPU.
    """
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    B, L = codes.shape
    nk = L - k + 1
    if nk < 1:
        raise ValueError(f"padded length {L} < k={k}")
    device = codes.device
    seeds = torch.tensor([s & _MASK33 for s in NTHASH_SEEDS], dtype=torch.int64, device=device)
    pos = torch.arange(L + 1, dtype=torch.int64, device=device)
    p = torch.zeros((B, L + 1), dtype=torch.int64, device=device)
    p[:, 1:] = _rot33(seeds[codes.long() & 3], (-pos[:L]) % 33)
    shift = 1
    while shift <= L:  # inclusive XOR scan along the row
        p[:, shift:] = p[:, shift:] ^ p[:, :-shift]
        shift *= 2
    i = pos[:nk]
    return _rot33(p[:, k:] ^ p[:, :nk], (k - 1 + i) % 33) & 0xFFFFFFFF
