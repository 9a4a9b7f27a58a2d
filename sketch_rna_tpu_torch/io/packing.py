"""Sequence validation and 2-bit base codes (numpy only).

Validation mirrors the reference exactly: only the uppercase characters
A, T, C, G are valid (reference is_valid_sequence, src/data_io.cpp:17-34);
anything else invalidates the whole sequence and the record is dropped.

Codes are A=0, C=1, G=2, T=3 (the order of the hash seed table); reads
pad into an [N, L] uint8 array with a lengths vector.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Lookup: ASCII byte -> base code, 255 = invalid.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _CODE_LUT[_b] = _c


def is_valid_sequence(seq: str) -> bool:
    """True iff seq contains only uppercase A/T/C/G
    (reference src/data_io.cpp:17-34). Empty sequences are valid there too."""
    arr = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    return bool((_CODE_LUT[arr] != 255).all())


def encode_sequence(seq: str) -> Optional[np.ndarray]:
    """Encode to uint8 base codes; None if any character is invalid."""
    arr = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    codes = _CODE_LUT[arr]
    if (codes == 255).any():
        return None
    return codes


@dataclasses.dataclass
class PackedReads:
    """Encoded reads as one padded host array.

    codes:   [N, L] uint8 base codes, zero-padded past each length.
    lengths: [N] int32 true lengths.
    ids:     read identifiers, aligned with rows.
    """

    codes: np.ndarray
    lengths: np.ndarray
    ids: List[str]

    @property
    def num_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def padded_len(self) -> int:
        return self.codes.shape[1]


def pack_reads(
    seqs: Sequence[str],
    ids: Sequence[str],
    min_len: int,
    pad_len: Optional[int] = None,
) -> Tuple[PackedReads, int, int]:
    """Validate, filter, and pack reads.

    Mirrors process_fastq_single_pass filtering (src/main.cpp:131-138):
    reads with non-ACGT characters or shorter than min_len (= max k) are
    dropped.  Reads longer than pad_len are also dropped (counted).

    Returns (packed, n_invalid, n_too_long).
    """
    kept_codes: List[np.ndarray] = []
    kept_ids: List[str] = []
    n_invalid = 0
    n_too_long = 0
    max_seen = 0
    for seq, rid in zip(seqs, ids):
        codes = encode_sequence(seq)
        if codes is None or codes.size < min_len:
            n_invalid += 1
            continue
        if pad_len is not None and codes.size > pad_len:
            n_too_long += 1
            continue
        max_seen = max(max_seen, codes.size)
        kept_codes.append(codes)
        kept_ids.append(rid)

    L = pad_len if pad_len is not None else max(max_seen, min_len)
    out = np.zeros((len(kept_codes), L), dtype=np.uint8)
    lengths = np.zeros(len(kept_codes), dtype=np.int32)
    for i, codes in enumerate(kept_codes):
        out[i, : codes.size] = codes
        lengths[i] = codes.size
    return PackedReads(out, lengths, kept_ids), n_invalid, n_too_long
