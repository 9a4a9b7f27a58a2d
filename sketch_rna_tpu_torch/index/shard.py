"""Hash-range sharding of the inverted index across the mesh's index axis.

Each shard owns a contiguous range of the sorted key space, cut at
near-equal posting mass so probe and expansion work balance: the same
cut points as sketch_rna_tpu/index/shard.py.  shard_k_index and
shard_index_arrays return that module's stacked [n_shards, *] arrays,
padded to a common width with never-matching sentinel keys (0xFFFFFFFF
exceeds every FracMinHash-kept hash for any fraction < 1).

A JAX program shards the stacked arrays over its devices; a rank of the
port uploads only its own row, without the padding (shard_to_device), so
the index memory of a rank falls with the width of the index axis.
Reads probe every shard with all their hashes; a hash another shard owns
simply does not match, and the partial events merge across the index
group (dist/quant_stream.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from sketch_rna_tpu_torch.index.artifact import DeviceIndex, DeviceKIndex, IndexArtifact

_SENTINEL = np.uint32(0xFFFFFFFF)


def shard_cuts(row_ptr: np.ndarray, num_keys: int, n_shards: int) -> List[int]:
    """n_shards + 1 ascending key positions that cut the keys at equal
    posting mass."""
    total = int(row_ptr[-1]) if num_keys else 0
    targets = [(total * s) // n_shards for s in range(n_shards + 1)]
    cuts = [int(np.searchsorted(row_ptr, t, side="left")) for t in targets]
    cuts[0], cuts[-1] = 0, num_keys
    return sorted(min(c, num_keys) for c in cuts)


def shard_k_index(
    keys: np.ndarray, row_ptr: np.ndarray, postings: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split one k's CSR arrays into [n_shards, *] stacked padded arrays."""
    cuts = shard_cuts(row_ptr, keys.shape[0], n_shards)
    u_pad = max(max((cuts[s + 1] - cuts[s]) for s in range(n_shards)), 1)
    p_pad = max(max((int(row_ptr[cuts[s + 1]] - row_ptr[cuts[s]])) for s in range(n_shards)), 1)
    out_keys = np.full((n_shards, u_pad), _SENTINEL, dtype=np.uint32)
    out_rp = np.zeros((n_shards, u_pad + 1), dtype=np.int32)
    out_post = np.zeros((n_shards, p_pad), dtype=np.int32)
    for s in range(n_shards):
        a, b = cuts[s], cuts[s + 1]
        nk = b - a
        p0, p1 = int(row_ptr[a]), int(row_ptr[b])
        out_keys[s, :nk] = keys[a:b]
        out_rp[s, : nk + 1] = row_ptr[a : b + 1] - p0
        out_rp[s, nk + 1 :] = out_rp[s, nk]
        out_post[s, : p1 - p0] = postings[p0:p1]
    return out_keys, out_rp, out_post


def shard_index_arrays(idx: IndexArtifact, n_shards: int) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-k stacked shard arrays for the whole artifact."""
    out = {}
    for k in idx.kmer_lengths:
        ki = idx.per_k[k]
        if ki.num_keys == 0:
            out[k] = (
                np.full((n_shards, 1), _SENTINEL, dtype=np.uint32),
                np.zeros((n_shards, 2), dtype=np.int32),
                np.zeros((n_shards, 1), dtype=np.int32),
            )
        else:
            out[k] = shard_k_index(ki.keys, ki.row_ptr, ki.postings, n_shards)
    return out


def shard_to_device(idx: IndexArtifact, n_shards: int, shard: int, device) -> DeviceIndex:
    """Shard `shard` of n_shards as a DeviceIndex on `device`: row `shard`
    of shard_index_arrays without its padding (so an empty k, or a shard
    that owns no key, uploads empty arrays)."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} is not one of {n_shards}")
    device = torch.device(device)
    per_k = {}
    for k in idx.kmer_lengths:
        ki = idx.per_k[k]
        row_ptr = np.asarray(ki.row_ptr).astype(np.int64) if ki.num_keys else np.zeros(1, np.int64)
        cuts = shard_cuts(row_ptr, ki.num_keys, n_shards)
        a, b = cuts[shard], cuts[shard + 1]
        p0, p1 = int(row_ptr[a]), int(row_ptr[b])
        per_k[k] = DeviceKIndex(
            keys=torch.from_numpy(np.asarray(ki.keys[a:b], np.uint32).astype(np.int64)).to(device),
            row_ptr=torch.from_numpy(row_ptr[a : b + 1] - p0).to(device),
            postings=torch.from_numpy(np.asarray(ki.postings[p0:p1], np.int32)).to(device),
        )
    return DeviceIndex(
        names=list(idx.names),
        lengths=np.asarray(idx.lengths),
        kmer_lengths=tuple(idx.kmer_lengths),
        sketch_fraction=idx.sketch_fraction,
        per_k=per_k,
        device=device,
    )


def device_index_bytes(index: DeviceIndex) -> int:
    """Bytes of a DeviceIndex's per-k tensors."""
    return sum(t.numel() * t.element_size() for ki in index.per_k.values()
               for t in (ki.keys, ki.row_ptr, ki.postings))
