"""Index artifact: the JAX package's `.npz` format, and its device form.

On disk (FORMAT_VERSION 1, identical to sketch_rna_tpu/index/artifact.py):

  per k:  keys    [U]   uint32, sorted distinct sketch hashes
          row_ptr [U+1] int32,  CSR offsets into postings
          postings[P]   int32,  transcript indices, ascending within a row
  global: names, lengths, kmer_lengths, sketch_fraction.

`to_device` carries an artifact — written by either package — into the
port's device tensors: keys and row_ptr as int64 (keys hold uint32
values; torch's uint32 lacks sort/searchsorted coverage), postings int32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

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


@dataclasses.dataclass
class DeviceIndex:
    """An index whose per-k arrays live on one device."""

    names: List[str]
    lengths: np.ndarray
    kmer_lengths: Tuple[int, ...]
    sketch_fraction: float
    per_k: Dict[int, DeviceKIndex]
    device: torch.device

    @property
    def num_transcripts(self) -> int:
        return len(self.names)


def to_device(idx: IndexArtifact, device) -> DeviceIndex:
    """Upload an artifact's per-k CSR arrays to `device`."""
    device = torch.device(device)
    per_k = {
        k: DeviceKIndex(
            keys=torch.from_numpy(np.asarray(ki.keys, np.uint32).astype(np.int64)).to(device),
            row_ptr=torch.from_numpy(np.asarray(ki.row_ptr).astype(np.int64)).to(device),
            postings=torch.from_numpy(np.asarray(ki.postings, np.int32)).to(device),
        )
        for k, ki in idx.per_k.items()
    }
    return DeviceIndex(
        names=list(idx.names),
        lengths=np.asarray(idx.lengths),
        kmer_lengths=tuple(idx.kmer_lengths),
        sketch_fraction=idx.sketch_fraction,
        per_k=per_k,
        device=device,
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
