"""The port's bucket-table probe (match/bucket_lookup.py) against the JAX
package's, on the CPU (the kernel P's plain version).

  - bucket_table_shape and the packed table of both port builders equal
    the JAX build_bucket_table exactly, and to_device's tables equal the
    JAX engine's _device_index tables (an empty k included);
  - bucket_lookup equals the JAX bucket_lookup and the port's
    searchsorted probe on hit, miss and masked lanes, at fractions 0.05,
    0.9999 and 1.0 (a key and a hash of 0xFFFFFFFF);
  - sketch_match_step gives the same candidate tables through the bucket
    probe and through the searchsorted probe.
"""

import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rna_tpu.match.bucket_lookup import bucket_lookup as jax_lookup
from sketch_rna_tpu.match.bucket_lookup import bucket_table_shape as jax_shape
from sketch_rna_tpu.match.bucket_lookup import build_bucket_table as jax_build
from sketch_rna_tpu.pipeline import _device_index
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import IndexArtifact, KIndex, to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import load_fasta
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.io.packing import pack_reads
from sketch_rna_tpu_torch.match.bucket_lookup import (
    bucket_lookup,
    bucket_lookup_plain,
    bucket_table_shape,
    build_bucket_table,
    build_bucket_table_device,
    device_bucket_table,
)
from sketch_rna_tpu_torch.match.probe import probe
from sketch_rna_tpu_torch.pipeline import sketch_match_step
from sketch_rna_tpu_torch.sketch.fracminhash import fracminhash_threshold

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _keys(case):
    """Sorted distinct uint32 keys of one case, and CSR row offsets."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "clustered":  # deep buckets: many keys in a narrow range
        keys = np.unique(rng.integers(1000, 3000, size=800).astype(np.uint32))
    elif case == "deep cluster":  # 1,000 keys under a 0xFFFFFFFF key: one bucket of 1,000 the merge cannot split
        keys = np.concatenate([np.sort(rng.choice(2001, 1000, replace=False)), [0xFFFFFFFF]]).astype(np.uint32)
    elif case.startswith("U="):
        U = int(case[2:])
        keys = np.unique(rng.integers(0, fracminhash_threshold(0.05) + 1, size=U, dtype=np.uint64)).astype(np.uint32)
        while keys.size < U:  # top up to exactly U distinct keys
            more = rng.integers(0, fracminhash_threshold(0.05) + 1, size=U - keys.size, dtype=np.uint64)
            keys = np.unique(np.concatenate([keys, more.astype(np.uint32)]))
    elif case == "fraction 0.9999":  # keys past 2^31
        top = fracminhash_threshold(0.9999) + 1
        keys = np.unique(rng.integers(0, top, size=5000, dtype=np.uint64)).astype(np.uint32)
    else:  # fraction 1.0: the top key 0xFFFFFFFF is a real key
        keys = np.unique(np.concatenate([rng.integers(0, 2**32, size=3000, dtype=np.uint64),
                                         [0xFFFFFFFF]]).astype(np.uint32))
    lens = rng.integers(1, 6, size=keys.size)
    row_ptr = np.zeros(keys.size + 1, np.int32)
    np.cumsum(lens, out=row_ptr[1:])
    return keys, row_ptr


TABLE_CASES = ["U=0", "U=1", "U=1000", "U=200000", "clustered", "deep cluster", "fraction 0.9999", "fraction 1.0"]


@pytest.mark.parametrize("case", TABLE_CASES)
def test_tables_equal_jax(case):
    keys, row_ptr = _keys(case)
    assert bucket_table_shape(keys) == jax_shape(keys)
    want = jax_build(keys, row_ptr)
    got = build_bucket_table(keys, row_ptr)
    assert (got.shift, got.mb) == (want.shift, want.mb)
    np.testing.assert_array_equal(got.packed, want.packed)
    if keys.size:
        nb, mb, shift = bucket_table_shape(keys)
        dev = build_bucket_table_device(torch.from_numpy(keys.astype(np.int64)),
                                        torch.from_numpy(row_ptr.astype(np.int64)), nb=nb, mb=mb, shift=shift)
        np.testing.assert_array_equal(dev.numpy(), want.packed)
    if case == "U=200000":
        assert 3 * got.mb <= 128  # the pair merge ran
    if case == "deep cluster":
        assert (got.mb, got.shift) == (1000, 22)  # the first histogram is not capped


def test_to_device_tables_equal_jax_device_index():
    """to_device builds each k's table as the JAX engine's _device_index
    does, the empty k's sentinel table included."""
    per_k, ks = {}, (15, 21, 31)
    for k, case in zip(ks, ("U=1000", "U=0", "clustered")):
        keys, row_ptr = _keys(case)
        per_k[k] = KIndex(keys=keys, row_ptr=row_ptr, postings=np.zeros(int(row_ptr[-1]), np.int32))
    art = IndexArtifact(names=["a"], lengths=np.ones(1, np.int32), kmer_lengths=ks, sketch_fraction=0.05, per_k=per_k)
    packed, _, metas = _device_index(art, ks)
    dev = to_device(art, "cpu")
    for k, p, (shift, mb) in zip(ks, packed, metas):
        t = dev.per_k[k].bucket
        assert (t.shift, t.mb) == (shift, mb)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(p))
    assert dev.bucket_bytes() == {k: int(np.asarray(p).size) * 4 for k, p in zip(ks, packed)}
    assert dev.upload_s > 0


@pytest.mark.parametrize("case", ["U=1000", "U=200000", "clustered", "deep cluster", "fraction 0.9999",
                                  "fraction 1.0"])
def test_lookup_equals_jax_and_probe(case):
    keys, row_ptr = _keys(case)
    rng = np.random.default_rng(3)
    B, S = 16, 40
    hits = rng.choice(keys, size=(B, S))
    miss = rng.integers(0, 2**32, size=(B, S), dtype=np.uint64).astype(np.uint32)
    q = np.where(rng.random((B, S)) < 0.6, hits, miss).astype(np.uint32)
    q[:, 0] = 0xFFFFFFFF  # the sentinel's bits: a hit only where it is a real key
    q[:, 1] = keys[-1]
    mask = rng.random((B, S)) < 0.8
    mask[:, :2] = True
    mask[0] = False  # a wholly masked read
    want = jax_build(keys, row_ptr)
    js, jl = jax_lookup(jnp.asarray(q), jnp.asarray(mask), jnp.asarray(want.packed), shift=want.shift, mb=want.mb)
    h, m = torch.from_numpy(q.astype(np.int64)), torch.from_numpy(mask)
    t = device_bucket_table(keys, torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(row_ptr.astype(np.int64)))
    start, length = bucket_lookup(h, m, t.packed, shift=t.shift, mb=t.mb)
    assert start.dtype == length.dtype == torch.int64 and start.shape == (B, S)
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jl))
    ps, pl = probe(h, m, torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(row_ptr.astype(np.int64)))
    assert torch.equal(start, ps) and torch.equal(length, pl)
    assert int((length > 0).sum()) > B  # hits were probed
    assert not length[0].any() and bool(length[1:, 1].all())
    assert bool(length[1:, 0].any()) == (case in ("fraction 1.0", "deep cluster"))


def test_lookup_on_an_empty_k_finds_nothing():
    empty = torch.zeros(0, dtype=torch.int64)
    t = device_bucket_table(np.zeros(0, np.uint32), empty, torch.zeros(1, dtype=torch.int64))
    h = torch.tensor([[0, 5, 0xFFFFFFFF]], dtype=torch.int64)
    start, length = bucket_lookup(h, torch.ones_like(h, dtype=torch.bool), t.packed, shift=t.shift, mb=t.mb)
    assert not start.any() and not length.any()


def test_bucket_lookup_rejects_bad_input():
    keys, row_ptr = _keys("U=1000")
    t = build_bucket_table(keys, row_ptr)
    packed = torch.from_numpy(t.packed)
    h = torch.zeros((2, 4), dtype=torch.int64)
    m = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        bucket_lookup(h.int(), m, packed, shift=t.shift, mb=t.mb)
    with pytest.raises(TypeError):
        bucket_lookup(h, m[:, :2], packed, shift=t.shift, mb=t.mb)
    with pytest.raises(ValueError):
        bucket_lookup(h, m, packed, shift=t.shift, mb=t.mb + 1)
    assert torch.equal(bucket_lookup(h, m, packed, shift=t.shift, mb=t.mb)[0],
                       bucket_lookup_plain(h, m, packed, shift=t.shift, mb=t.mb)[0])


@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_sketch_match_step_bucket_equals_searchsorted(ks):
    """The sample through both probes: integer-identical tables and stats."""
    cfg = QuantConfig(kmer_lengths=ks, batch_size=256)
    idx = to_device(build_index(load_fasta(os.path.join(EXAMPLES, "sample.fa")), cfg, device="cpu"), "cpu")
    reads = load_fastq_dict(os.path.join(EXAMPLES, "sample.fq"), min_len=max(ks))
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=max(ks), pad_len=256)
    L = 160
    c = torch.from_numpy(np.ascontiguousarray(packed.codes[:256, :L]))
    n = torch.from_numpy(packed.lengths[:256].astype(np.int32))
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    got = sketch_match_step(c, n, idx, cfg, caps)
    want = sketch_match_step(c, n, idx, cfg, caps, lookup=lambda h, m, ki: probe(h, m, ki.keys, ki.row_ptr))
    for f in ("tid", "score", "mask"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
    assert int(got.mask.sum()) > 100
