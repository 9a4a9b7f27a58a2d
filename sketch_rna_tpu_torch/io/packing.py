"""Sequence validation and 2-bit base codes (numpy only).

Validation mirrors the reference exactly: only the uppercase characters
A, T, C, G are valid (reference is_valid_sequence, src/data_io.cpp:17-34);
anything else invalidates the whole sequence and the record is dropped.

Codes are A=0, C=1, G=2, T=3 (the order of the hash seed table); reads
pad into an [N, L] uint8 array with a lengths vector (PackedReads), or
four codes to a byte (Packed2Reads), which quarters the bytes a
streaming feed uploads; unpack_codes2 expands them on the host or on the
device.
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

    def bit_packed(self) -> "Packed2Reads":
        """2-bit repack (4 bases per byte) for transfer-efficient feeds."""
        n, L = self.codes.shape
        L4 = (L + 3) // 4
        c = self.codes
        if L4 * 4 != L:
            c = np.concatenate([c, np.zeros((n, L4 * 4 - L), np.uint8)], axis=1)
        q = c.reshape(n, L4, 4).astype(np.uint8)
        codes2 = q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (q[:, :, 3] << 6)
        return Packed2Reads(codes2, self.lengths, L)


@dataclasses.dataclass
class Packed2Reads:
    """2-bit-packed reads: base j of a row in byte j >> 2, bits (j & 3) * 2.

    codes2:  [N, ceil(L/4)] uint8 packed base codes, zero past lengths.
    lengths: [N] int32 true lengths.
    pad_len: the padded read length L the rows unpack to.
    n_real:  rows that hold reads when the block was padded to a batch
             multiple on the host; None = every row.
    """

    codes2: np.ndarray
    lengths: np.ndarray
    pad_len: int
    n_real: Optional[int] = None

    @property
    def num_reads(self) -> int:
        return self.n_real if self.n_real is not None else self.codes2.shape[0]

    @property
    def padded_len(self) -> int:
        return self.pad_len


def unpack_codes2(codes2, L: int):
    """[..., ceil(L/4)] uint8 -> [..., L] base codes, by shifts and masks:
    a numpy array unpacks on the host, a torch tensor on its device."""
    if isinstance(codes2, np.ndarray):
        shifts = np.arange(4, dtype=np.uint8) * 2
    else:
        import torch

        shifts = torch.arange(4, dtype=torch.uint8, device=codes2.device) * 2
    out = (codes2[..., None] >> shifts) & 3
    return out.reshape(*codes2.shape[:-1], codes2.shape[-1] * 4)[..., :L]


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
