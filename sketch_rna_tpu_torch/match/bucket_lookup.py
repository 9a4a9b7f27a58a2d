"""Bucketed index probe: sketch hashes -> posting runs through one
direct-address table per k (sketch_rna_tpu/match/bucket_lookup.py's
counterpart; the port keeps its own copy of the table rules).

FracMinHash-kept hashes are uniform below the threshold, so a table of a
power-of-two number of buckets, bucket(key) = key >> shift, holds O(1)
keys a bucket.  Each bucket is one int32 row of three mb-wide parts,
[key bits | start | length], mb the largest occupancy; unused key slots
hold the sentinel -1 (start and length 0), so a probe's masked sum over
the matching slots is the posting run of its hash, or (0, 0).

  build_bucket_table / bucket_table_shape   numpy, on the host, exactly
                                            the JAX package's choices
  build_bucket_table_device                 the same table, built with
                                            torch on the index's device
  bucket_lookup                             the probe: the kernel P
                                            (csrc/bucket_probe.cu) on a
                                            CUDA tensor, its plain version
                                            bucket_lookup_plain on the CPU

Keys travel as the port's int64 holding uint32 values and are bit-cast
to int32 for the table, as the JAX package bit-casts them.  The output is
the (start, length) int64 [B, S] of match/probe.py's probe, equal to it
value for value.  The fused and streamed engines probe through here
(pipeline.sketch_match_step); the sharded route keeps probe's binary
search over its hash-range shard, as the JAX shard_map route does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sketch_rna_tpu_torch import kernels

TARGET_LOAD = 2
MAX_ROW_LANES = 128


@dataclasses.dataclass(frozen=True)
class BucketTable:
    packed: torch.Tensor  # [nb, 3 * mb] int32 (a numpy array from build_bucket_table)
    shift: int  # bucket = hash >> shift
    mb: int  # max bucket occupancy (padded width)

    @property
    def nbytes(self) -> int:
        return int(self.packed.numel()) * 4


def bucket_table_shape(keys: np.ndarray, target_load: int = TARGET_LOAD,
                       max_row_lanes: int = MAX_ROW_LANES) -> Tuple[int, int, int]:
    """(nb, mb, shift) of a k's table from its sorted uint32 keys: a
    power-of-two bucket count near U / target_load (2^10 .. 2^22), the
    shift that maps the largest key into it, then bucket pairs merged
    while the widest merged row's 3 * mb still fits max_row_lanes (the
    histogram summed pairwise, no re-bucketing)."""
    keys = np.asarray(keys, dtype=np.uint32)
    U = int(keys.shape[0])
    nb = 1 << max(10, min(22, (max(U // target_load, 1)).bit_length()))
    max_key = int(keys.max()) if U else 0
    shift = 0
    while (max_key >> shift) >= nb:
        shift += 1
    b = (keys.astype(np.uint64) >> shift).astype(np.int64)
    counts = np.bincount(b, minlength=nb) if U else np.zeros(nb, np.int64)
    while nb > 1024:
        merged = counts.reshape(-1, 2).sum(axis=1)
        if 3 * max(int(merged.max()) if U else 0, 1) > max_row_lanes:
            break
        counts = merged
        nb >>= 1
        shift += 1
    mb = max(int(counts.max()) if U else 0, 1)
    return nb, mb, shift


def build_bucket_table(keys: np.ndarray, row_ptr: np.ndarray, target_load: int = TARGET_LOAD,
                       max_row_lanes: int = MAX_ROW_LANES):
    """The packed [nb, 3 * mb] int32 table on the host, as a BucketTable
    whose `packed` is a numpy array.  Keys are sorted, so each bucket is
    a contiguous run and a key's slot is its index minus its bucket's
    first index."""
    keys = np.asarray(keys, dtype=np.uint32)
    U = int(keys.shape[0])
    nb, mb, shift = bucket_table_shape(keys, target_load, max_row_lanes)
    b = (keys.astype(np.uint64) >> shift).astype(np.int64)
    counts = np.bincount(b, minlength=nb) if U else np.zeros(nb, np.int64)
    packed = np.zeros((nb, 3 * mb), dtype=np.int32)
    packed[:, :mb] = -1
    if U:
        starts = np.zeros(nb, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(U, dtype=np.int64) - starts[b]
        row_ptr = np.asarray(row_ptr)
        packed[b, within] = keys.view(np.int32)
        packed[b, mb + within] = row_ptr[:-1]
        packed[b, 2 * mb + within] = (row_ptr[1:] - row_ptr[:-1]).astype(np.int32)
    return BucketTable(packed=packed, shift=shift, mb=mb)


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> the same 32 bits as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def build_bucket_table_device(keys: torch.Tensor, row_ptr: torch.Tensor, *, nb: int, mb: int,
                              shift: int) -> torch.Tensor:
    """The packed [nb, 3 * mb] int32 table, built on keys' device from a
    k's CSR arrays (keys [U] int64 holding sorted uint32 values, row_ptr
    [U + 1]) and the host's (nb, mb, shift): equal to build_bucket_table.
    Each (bucket, slot) target is distinct, so the three writes are
    plain index assignments."""
    U = keys.shape[0]
    dev = keys.device
    b = (keys.to(torch.int64) >> shift).to(torch.int64)
    counts = torch.zeros(nb, dtype=torch.int64, device=dev)
    counts.index_add_(0, b, torch.ones_like(b))
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(U, dtype=torch.int64, device=dev) - starts[b]
    packed = torch.zeros((nb, 3 * mb), dtype=torch.int32, device=dev)
    packed[:, :mb] = -1
    rp = row_ptr.to(torch.int64)
    packed[b, within] = as_int32_bits(keys)
    packed[b, mb + within] = rp[:-1].to(torch.int32)
    packed[b, 2 * mb + within] = (rp[1:] - rp[:-1]).to(torch.int32)
    return packed


def device_bucket_table(host_keys: np.ndarray, keys: torch.Tensor, row_ptr: torch.Tensor) -> BucketTable:
    """One k's table on keys' device from its uploaded CSR arrays (keys
    [U] int64 holding sorted uint32 values, row_ptr [U + 1]): the shape
    decided on the host from host_keys, the same keys as uint32
    (bucket_table_shape), the table built on the device.  An empty k gets
    one never-matching sentinel key 0xFFFFFFFF with an empty run, as the
    JAX package pads it."""
    host_keys = np.asarray(host_keys, dtype=np.uint32)
    if host_keys.shape[0] == 0:
        host_keys = np.array([0xFFFFFFFF], np.uint32)
        keys = torch.from_numpy(host_keys.astype(np.int64)).to(keys.device)
        row_ptr = torch.zeros(2, dtype=torch.int64, device=keys.device)
    nb, mb, shift = bucket_table_shape(host_keys)
    return BucketTable(packed=build_bucket_table_device(keys, row_ptr, nb=nb, mb=mb, shift=shift), shift=shift, mb=mb)


def bucket_lookup_plain(hashes: torch.Tensor, mask: torch.Tensor, packed: torch.Tensor, *, shift: int,
                        mb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of P, the JAX package's probe: gather
    each hash's whole bucket row, compare the key part, masked sums of
    the start and length parts (int32, widened to int64)."""
    nb = packed.shape[0]
    b = torch.clamp((hashes & 0xFFFFFFFF) >> shift, max=nb - 1)
    rows = packed[b]  # [B, S, 3 * mb]
    eq = (rows[..., :mb] == as_int32_bits(hashes)[..., None]) & mask[..., None]
    zero = torch.zeros((), dtype=torch.int32, device=packed.device)
    start = torch.where(eq, rows[..., mb : 2 * mb], zero).sum(dim=-1, dtype=torch.int32)
    length = torch.where(eq, rows[..., 2 * mb :], zero).sum(dim=-1, dtype=torch.int32)
    return start.to(torch.int64), length.to(torch.int64)


def bucket_lookup(hashes: torch.Tensor, mask: torch.Tensor, packed: torch.Tensor, *, shift: int,
                  mb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] hashes (int64 holding uint32) + validity mask -> (start,
    length) [B, S] int64 through a k's packed table.  On a CUDA tensor
    the kernel P (or an exception), on a CPU tensor bucket_lookup_plain."""
    if hashes.dtype != torch.int64 or mask.dtype != torch.bool or hashes.shape != mask.shape:
        raise TypeError(f"bucket_lookup takes int64 hashes and a bool mask of one shape, got {hashes.dtype} "
                        f"{tuple(hashes.shape)} and {mask.dtype} {tuple(mask.shape)}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or packed.shape[1] != 3 * mb or mb < 1:
        raise ValueError(f"packed must be an [nb, 3 * {mb}] int32 table, got {packed.dtype} {tuple(packed.shape)}")
    if not (hashes.device == mask.device == packed.device):
        raise ValueError("hashes, mask and table must be on one device")
    if hashes.device.type == "cpu":
        return bucket_lookup_plain(hashes, mask, packed, shift=shift, mb=mb)
    if hashes.device.type != "cuda":
        raise ValueError(f"unsupported device {hashes.device}")
    if hashes.numel() >= 1 << 31 or packed.numel() >= 1 << 31:
        raise ValueError("bucket_lookup: more lanes than the kernel's int32 index")
    h, m, table = hashes.contiguous(), mask.contiguous(), packed.contiguous()
    start = torch.empty_like(h)
    length = torch.empty_like(h)
    if h.numel():
        err = kernels.library().bucket_probe_launch(
            h.data_ptr(), m.data_ptr(), table.data_ptr(), start.data_ptr(), length.data_ptr(),
            h.numel(), packed.shape[0], mb, shift, torch.cuda.current_stream(h.device).cuda_stream,
        )
        kernels.check(err, "bucket_probe_launch")
        bucket_lookup.launches += 1
    return start, length


def probe_index(hashes: torch.Tensor, mask: torch.Tensor, kindex) -> Tuple[torch.Tensor, torch.Tensor]:
    """bucket_lookup on a DeviceKIndex's table (index/artifact.py)."""
    table = kindex.bucket
    if table is None:
        raise ValueError("this index has no bucket tables (an index shard probes with match.probe.probe)")
    return bucket_lookup(hashes, mask, table.packed, shift=table.shift, mb=table.mb)


def probe_index_plain(hashes: torch.Tensor, mask: torch.Tensor, kindex) -> Tuple[torch.Tensor, torch.Tensor]:
    """probe_index through the plain version, on any device."""
    table = kindex.bucket
    return bucket_lookup_plain(hashes, mask, table.packed, shift=table.shift, mb=table.mb)


# Kernel launches since the last reset.
bucket_lookup.launches = 0
