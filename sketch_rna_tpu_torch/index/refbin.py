"""The reference binary's own index layout (src/data_io.cpp:165-304).

A numpy copy of sketch_rna_tpu/index/refbin.py that returns the port's
IndexArtifact, so an index written by the C++ tool, by the JAX package
or by the port loads in any of them:

  [size_t n_k][u32 k]*n_k
  [size_t n_transcripts]
    per transcript: [size_t idLen][id][size_t seqLen][seq][i32 length]
  [size_t n_maps]
    per map: [u32 k][size_t mapSize]
      per hash: [u32 hash][size_t nPostings]
        per posting: [size_t tidLen][tid]

All fields little-endian LP64 host layout.  Quant never reads the
serialized sequences: the reader drops them, and the writer emits them
when given (empty strings otherwise, which the reference loader accepts).
Transcript order in the file defines transcript indices on read.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from sketch_rna_tpu_torch.index.artifact import IndexArtifact, KIndex, load_index


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _unpack(self, fmt: str, size: int) -> int:
        (v,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return v

    def u64(self) -> int:
        return self._unpack("<Q", 8)

    def u32(self) -> int:
        return self._unpack("<I", 4)

    def i32(self) -> int:
        return self._unpack("<i", 4)

    def bytes_(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v


def read_refbin_index(path: str) -> IndexArtifact:
    with open(path, "rb") as fh:
        r = _Reader(fh.read())
    kmer_lengths = tuple(r.u32() for _ in range(r.u64()))
    n_t = r.u64()
    names: List[str] = []
    lengths = np.zeros(n_t, dtype=np.int32)
    name_to_idx: Dict[str, int] = {}
    for i in range(n_t):
        name = r.bytes_(r.u64()).decode()
        seq_len = r.u64()
        r.bytes_(seq_len)  # sequences are unused in quant
        length = r.i32()
        names.append(name)
        # Reference quirk Q2 writes length 0; recover the real length
        # from the serialized sequence when the stored field is useless.
        lengths[i] = length if length > 0 else seq_len
        name_to_idx[name] = i

    per_k: Dict[int, KIndex] = {}
    for _ in range(r.u64()):
        k = r.u32()
        hashes: List[int] = []
        postings_per_hash: List[List[int]] = []
        for _ in range(r.u64()):
            hashes.append(r.u32())
            n_post = r.u64()
            postings_per_hash.append(sorted(name_to_idx[r.bytes_(r.u64()).decode()] for _ in range(n_post)))
        order = np.argsort(np.asarray(hashes, dtype=np.uint32), kind="stable")
        row_ptr = np.zeros(len(hashes) + 1, dtype=np.int32)
        flat: List[int] = []
        for j, oi in enumerate(order):
            flat.extend(postings_per_hash[oi])
            row_ptr[j + 1] = len(flat)
        per_k[int(k)] = KIndex(
            keys=np.asarray(hashes, dtype=np.uint32)[order],
            row_ptr=row_ptr,
            postings=np.asarray(flat, dtype=np.int32),
        )

    empty = KIndex(keys=np.zeros(0, np.uint32), row_ptr=np.zeros(1, np.int32), postings=np.zeros(0, np.int32))
    ks = tuple(int(k) for k in kmer_lengths)
    return IndexArtifact(
        names=names,
        lengths=lengths,
        kmer_lengths=ks,
        sketch_fraction=0.05,  # not stored in the reference format
        per_k={k: per_k.get(k, empty) for k in ks},
    )


def write_refbin_index(path: str, idx: IndexArtifact, seqs: Optional[Sequence[str]] = None) -> None:
    """Write an artifact in the reference binary layout; seqs (aligned
    with idx.names) are serialized when given, as the reference does."""
    with open(path, "wb") as fh:
        w = fh.write
        w(struct.pack("<Q", len(idx.kmer_lengths)))
        for k in idx.kmer_lengths:
            w(struct.pack("<I", k))
        w(struct.pack("<Q", len(idx.names)))
        for i, name in enumerate(idx.names):
            nb = name.encode()
            sb = (seqs[i] if seqs is not None else "").encode()
            w(struct.pack("<Q", len(nb)) + nb + struct.pack("<Q", len(sb)) + sb)
            w(struct.pack("<i", int(idx.lengths[i])))
        w(struct.pack("<Q", len(idx.per_k)))
        encoded = [name.encode() for name in idx.names]
        for k, ki in idx.per_k.items():
            w(struct.pack("<I", k))
            w(struct.pack("<Q", ki.num_keys))
            for j in range(ki.num_keys):
                a, b = int(ki.row_ptr[j]), int(ki.row_ptr[j + 1])
                w(struct.pack("<IQ", int(ki.keys[j]), b - a))
                for t in ki.postings[a:b]:
                    tb = encoded[int(t)]
                    w(struct.pack("<Q", len(tb)) + tb)


def is_npz_index(path: str) -> bool:
    """npz artifacts are zip files (magic 'PK'); the reference binary
    format starts with a small size_t count."""
    with open(path, "rb") as fh:
        return fh.read(2) == b"PK"


def load_any_index(path: str) -> IndexArtifact:
    """Either format, detected from the file's first bytes."""
    return load_index(path) if is_npz_index(path) else read_refbin_index(path)
