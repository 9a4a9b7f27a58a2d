"""Index artifact: the JAX package's `.npz` format, and its device form.

On disk (FORMAT_VERSION 1, identical to sketch_rna_tpu/index/artifact.py):

  per k:  keys    [U]   uint32, sorted distinct sketch hashes
          row_ptr [U+1] int32,  CSR offsets into postings
          postings[P]   int32,  transcript indices, ascending within a row
  global: names, lengths, kmer_lengths, sketch_fraction.

`to_device` carries an artifact — written by either package — into the
port's device tensors: keys and row_ptr as int64 (keys hold uint32
values; torch's uint32 lacks sort/searchsorted coverage), postings int32,
and each k's packed bucket table (match/bucket_lookup.py), built on the
device from the uploaded CSR arrays as the JAX package's _device_index
builds it: the probe table of the fused and streamed engines.  The
upload's seconds, tables included, are set-up (`upload_s`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sketch_rna_tpu_torch.match.bucket_lookup import BucketTable, device_bucket_table
from sketch_rna_tpu_torch.utils.step_graphs import GraphStore

FORMAT_VERSION = 1


@dataclasses.dataclass
class KIndex:
    """Inverted index for one k-mer length (CSR over sorted hash keys)."""

    keys: np.ndarray  # [U] uint32 sorted
    row_ptr: np.ndarray  # [U+1] int32
    postings: np.ndarray  # [P] int32 transcript indices

    @property
    def num_keys(self) -> int:
        return int(self.keys.shape[0])

    def sha256(self) -> str:
        """Hex sha256 over keys (uint32) | row_ptr (int32) | postings
        (int32), each little-endian as the artifact stores them: equal
        digests, bit-equal indexes."""
        h = hashlib.sha256()
        for a, dtype in ((self.keys, "<u4"), (self.row_ptr, "<i4"), (self.postings, "<i4")):
            h.update(np.ascontiguousarray(a, dtype=dtype).tobytes())
        return h.hexdigest()


@dataclasses.dataclass
class IndexArtifact:
    names: List[str]  # all transcripts kept by load_fasta, input order
    lengths: np.ndarray  # [T] int32 true sequence lengths
    kmer_lengths: Tuple[int, ...]
    sketch_fraction: float
    per_k: Dict[int, KIndex]

    @property
    def num_transcripts(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class DeviceKIndex:
    keys: torch.Tensor  # [U] int64 holding uint32 values, ascending
    row_ptr: torch.Tensor  # [U+1] int64
    postings: torch.Tensor  # [P] int32
    # The probe table; None on an index shard (index/shard.py), whose
    # route binary-searches keys (match/probe.py).
    bucket: Optional[BucketTable] = None


@dataclasses.dataclass
class DeviceIndex:
    """An index whose per-k arrays live on one device."""

    names: List[str]
    lengths: np.ndarray
    kmer_lengths: Tuple[int, ...]
    sketch_fraction: float
    per_k: Dict[int, DeviceKIndex]
    device: torch.device
    upload_s: float = 0.0  # to_device's seconds, bucket tables included
    # The match stage's CUDA graphs on this index (utils/step_graphs.py):
    # made empty with every DeviceIndex, dataclasses.replace included.
    graphs: GraphStore = dataclasses.field(default_factory=GraphStore, init=False, repr=False, compare=False)

    @property
    def num_transcripts(self) -> int:
        return len(self.names)

    def bucket_bytes(self) -> Dict[int, int]:
        """Device bytes of each k's bucket table (0 on a shard)."""
        return {k: ki.bucket.nbytes if ki.bucket is not None else 0 for k, ki in self.per_k.items()}


def to_device(idx: IndexArtifact, device) -> DeviceIndex:
    """Upload an artifact's per-k CSR arrays to `device` and build each
    k's bucket table there."""
    device = torch.device(device)
    t0 = time.perf_counter()
    per_k = {}
    for k, ki in idx.per_k.items():
        keys = torch.from_numpy(np.asarray(ki.keys, np.uint32).astype(np.int64)).to(device)
        row_ptr = torch.from_numpy(np.asarray(ki.row_ptr).astype(np.int64)).to(device)
        per_k[k] = DeviceKIndex(
            keys=keys,
            row_ptr=row_ptr,
            postings=torch.from_numpy(np.asarray(ki.postings, np.int32)).to(device),
            bucket=device_bucket_table(ki.keys, keys, row_ptr),
        )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return DeviceIndex(
        names=list(idx.names),
        lengths=np.asarray(idx.lengths),
        kmer_lengths=tuple(idx.kmer_lengths),
        sketch_fraction=idx.sketch_fraction,
        per_k=per_k,
        device=device,
        upload_s=time.perf_counter() - t0,
    )


def save_index(path: str, idx: IndexArtifact) -> None:
    arrays = {
        "format_version": np.int32(FORMAT_VERSION),
        "names": np.array(idx.names, dtype=np.str_),
        "lengths": idx.lengths.astype(np.int32),
        "kmer_lengths": np.array(idx.kmer_lengths, dtype=np.int32),
        "sketch_fraction": np.float64(idx.sketch_fraction),
    }
    for k, ki in idx.per_k.items():
        arrays[f"k{k}_keys"] = ki.keys.astype(np.uint32)
        arrays[f"k{k}_row_ptr"] = ki.row_ptr.astype(np.int32)
        arrays[f"k{k}_postings"] = ki.postings.astype(np.int32)
    # Through a file object, so np.savez does not append ".npz" to a
    # name the caller chose.
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load_index(path: str) -> IndexArtifact:
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported index format version {version}")
        kmer_lengths = tuple(int(k) for k in z["kmer_lengths"])
        per_k = {
            k: KIndex(
                keys=z[f"k{k}_keys"],
                row_ptr=z[f"k{k}_row_ptr"],
                postings=z[f"k{k}_postings"],
            )
            for k in kmer_lengths
        }
        return IndexArtifact(
            names=[str(n) for n in z["names"]],
            lengths=z["lengths"],
            kmer_lengths=kmer_lengths,
            sketch_fraction=float(z["sketch_fraction"]),
            per_k=per_k,
        )
