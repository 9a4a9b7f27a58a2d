"""The port's mesh chooser, index shards and byte-range FASTQ readers
against the JAX package's, on the same inputs (integers and strings:
equal, no tolerance), plus the port's own rules where it differs on
purpose:

  - mesh_factor: equal on a grid of (devices, max shards, index bytes,
    budget), tests/test_sharded.py's cases included; the default budget
    is the port's own (a share of an H100), the env override the same;
  - index_device_bytes counts the port's device index, not bucket tables;
  - shard_k_index / shard_index_arrays: array-equal for 1, 2, 3, 4 and 8
    shards and an empty k; shard_to_device uploads row i without padding;
  - byte_range_for_process, iter_fastq_records_range and
    load_fastq_dict_range: equal on files with '@'-leading quality
    lines, CRLF line ends, a truncated last record and more processes
    than records, wherever no range starts exactly on a record header.
    There the JAX reader skips that record in both ranges; the port's
    keeps it, so its ranges' union is the sequential parse with no record
    twice, for every split;
  - the collectives are the identity on a group of one; without a
    coordinator init_distributed does nothing, and a bad rank raises.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.dist.mesh import mesh_factor as jax_mesh_factor
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.index.shard import shard_index_arrays as jax_shard_index_arrays
from sketch_rna_tpu.index.shard import shard_k_index as jax_shard_k_index
from sketch_rna_tpu.io import fastq as jax_fastq
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu_torch.dist import collectives
from sketch_rna_tpu_torch.dist.init import init_distributed, pick_backend, rank_device
from sketch_rna_tpu_torch.dist.mesh import DEFAULT_INDEX_HBM_BUDGET, Mesh, index_device_bytes, make_mesh, mesh_factor
from sketch_rna_tpu_torch.index.artifact import KIndex, to_device
from sketch_rna_tpu_torch.index.shard import (device_index_bytes, shard_cuts, shard_index_arrays, shard_k_index,
                                              shard_to_device)
from sketch_rna_tpu_torch.io import fastq as port_fastq

from util import decode, make_transcriptome

GIB = 1 << 30


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_mesh_factor_equals_jax(n_devices):
    for max_shards, (index_bytes, budget) in itertools.product(
        (1, 2, 4, 8),
        [(None, None), (1 * GIB, 4 * GIB), (12 * GIB, 4 * GIB), (60 * GIB, 4 * GIB), (5 * GIB, 1 * GIB), (7, 2)],
    ):
        kw = dict(max_index_shards=max_shards, index_bytes=index_bytes, hbm_budget_bytes=budget)
        got = mesh_factor(n_devices, **kw)
        assert got == jax_mesh_factor(n_devices, **kw), (n_devices, kw)
        assert got[0] * got[1] == n_devices


def test_mesh_factor_known_cases():
    # tests/test_sharded.py:44-69
    assert mesh_factor(8) == (4, 2) and mesh_factor(2) == (2, 1) and mesh_factor(1) == (1, 1)
    assert mesh_factor(16, max_index_shards=4) == (4, 4)
    assert mesh_factor(32, max_index_shards=8) == (8, 4)
    assert mesh_factor(6, max_index_shards=4) == (3, 2)
    assert mesh_factor(8, index_bytes=12 * GIB, hbm_budget_bytes=4 * GIB) == (2, 4)
    assert mesh_factor(8, index_bytes=60 * GIB, hbm_budget_bytes=4 * GIB) == (1, 8)
    assert mesh_factor(1, index_bytes=60 * GIB, hbm_budget_bytes=4 * GIB) == (1, 1)
    assert mesh_factor(6, index_bytes=12 * GIB, hbm_budget_bytes=4 * GIB) == (2, 3)


def test_mesh_factor_budget_default_and_env(monkeypatch):
    # The default is the port's own: 12 GiB fits a share of an H100.
    monkeypatch.delenv("SKETCH_TPU_INDEX_HBM_BUDGET", raising=False)
    assert DEFAULT_INDEX_HBM_BUDGET == 20 * GIB
    assert mesh_factor(8, index_bytes=12 * GIB) == (4, 2)
    assert mesh_factor(8, index_bytes=50 * GIB) == (2, 4)
    monkeypatch.setenv("SKETCH_TPU_INDEX_HBM_BUDGET", str(4 * GIB))
    assert mesh_factor(8, index_bytes=12 * GIB) == jax_mesh_factor(8, index_bytes=12 * GIB) == (2, 4)


@pytest.fixture(scope="module")
def artifact():
    rng = np.random.default_rng(99)
    seqs = make_transcriptome(rng, n=14, len_range=(60, 400))
    recs = JaxRecords([f"T{i:03d}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    return jax_build_index(recs, JaxConfig(kmer_lengths=(21, 31)))


def test_index_device_bytes_counts_the_device_index(artifact):
    dev = to_device(artifact, "cpu")
    assert index_device_bytes(artifact) == device_index_bytes(dev) > 0


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shards_equal_jax(artifact, n_shards):
    want = jax_shard_index_arrays(artifact, n_shards)
    got = shard_index_arrays(artifact, n_shards)
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        ki = artifact.per_k[k]
        for g, w in zip(shard_k_index(ki.keys, ki.row_ptr, ki.postings, n_shards),
                        jax_shard_k_index(ki.keys, ki.row_ptr, ki.postings, n_shards)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_to_device_is_the_row_without_padding(artifact, n_shards):
    stacked = shard_index_arrays(artifact, n_shards)
    total = 0
    for i in range(n_shards):
        shard = shard_to_device(artifact, n_shards, i, "cpu")
        total += sum(s.postings.numel() for s in shard.per_k.values())
        for k in artifact.kmer_lengths:
            keys, row_ptr, postings = (a[i] for a in stacked[k])
            s = shard.per_k[k]
            nk, npost = s.keys.numel(), s.postings.numel()
            assert s.keys.dtype == s.row_ptr.dtype == torch.int64 and s.postings.dtype == torch.int32
            np.testing.assert_array_equal(s.keys.numpy(), keys[:nk].astype(np.int64))
            assert (keys[nk:] == 0xFFFFFFFF).all()
            np.testing.assert_array_equal(s.row_ptr.numpy(), row_ptr[: nk + 1])
            assert (row_ptr[nk:] == npost).all()
            np.testing.assert_array_equal(s.postings.numpy(), postings[:npost])
    assert total == sum(artifact.per_k[k].postings.shape[0] for k in artifact.kmer_lengths)
    with pytest.raises(ValueError):
        shard_to_device(artifact, n_shards, n_shards, "cpu")


def test_shards_of_an_empty_k(artifact):
    import copy

    idx = copy.copy(artifact)
    idx.per_k = dict(artifact.per_k)
    idx.per_k[21] = KIndex(np.zeros(0, np.uint32), np.zeros(1, np.int32), np.zeros(0, np.int32))
    want, got = jax_shard_index_arrays(idx, 3), shard_index_arrays(idx, 3)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    shard = shard_to_device(idx, 3, 1, "cpu")
    assert shard.per_k[21].keys.numel() == 0 and shard.per_k[21].postings.numel() == 0
    assert shard.per_k[21].row_ptr.tolist() == [0]
    assert shard_cuts(np.zeros(1, np.int64), 0, 3) == [0, 0, 0, 0]


def _fastq_files(tmp):
    rng = np.random.default_rng(7)

    def seq(n):
        return decode(rng.integers(0, 4, size=n).astype(np.uint8))

    plain, at_quality = [], []
    for i in range(23):
        s = seq(int(rng.integers(20, 70)))
        plain.append(f"@r{i} desc\n{s}\n+\n{'I' * len(s)}\n")
        # a quality line that starts with '@', and one that starts with '+'
        q = ("@" if i % 2 else "+") + "I" * (len(s) - 1)
        at_quality.append(f"@q{i}\n{s}\n+q{i}\n{q}\n")
    files = {
        "plain": "".join(plain),
        "at-quality": "".join(at_quality),
        "crlf": "".join(plain).replace("\n", "\r\n"),
        "truncated": "".join(plain) + "@last\nACGTACGTACGTACGTACGTACGT\n",
        "junk-between": "junk\n" + "\nnoise\n".join(plain),
        "three": "".join(plain[:3]),
        "empty": "",
    }
    paths = {}
    for name, text in files.items():
        paths[name] = os.path.join(tmp, f"{name}.fq")
        with open(paths[name], "w", newline="") as fh:
            fh.write(text)
    return paths


def _header_offsets(path):
    """Byte offsets of the records' headers, by a sequential pass."""
    offsets, pos = [], 0
    with open(path, "rb") as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        if lines[i][:1] == b"@":
            offsets.append(pos)
            step = 4
        else:
            step = 1
        pos += sum(len(ln) for ln in lines[i : i + step])
        i += step
    return offsets


@pytest.mark.parametrize("name", ["plain", "at-quality", "crlf", "truncated", "junk-between", "three", "empty"])
def test_byte_ranges_equal_jax(tmp_path, name):
    path = _fastq_files(str(tmp_path))[name]
    headers = set(_header_offsets(path))
    compared = 0
    for n_proc in (1, 2, 3, 5, 7, 40):
        for p in range(n_proc):
            rng_port = port_fastq.byte_range_for_process(path, p, n_proc)
            assert rng_port == jax_fastq.byte_range_for_process(path, p, n_proc)
            if rng_port[0] in headers and rng_port[0] > 0:
                continue  # the JAX reader loses the record that starts exactly here
            if p + 1 < n_proc and rng_port[1] in headers:
                continue
            compared += 1
            assert list(port_fastq.iter_fastq_records_range(path, *rng_port)) == list(
                jax_fastq.iter_fastq_records_range(path, *rng_port))
            assert port_fastq.load_fastq_dict_range(path, *rng_port, min_len=21) == jax_fastq.load_fastq_dict_range(
                path, *rng_port, min_len=21)
    assert compared >= 6


@pytest.mark.parametrize("name", ["plain", "at-quality", "junk-between", "three", "empty"])
def test_byte_ranges_cover_the_file_once(tmp_path, name):
    """The union over the ranges is the sequential parse, in order, with
    no record twice: for every split count, ranges that start on a header
    included (every cut of the file at a header's first byte is tried)."""
    path = _fastq_files(str(tmp_path))[name]
    whole = list(port_fastq.iter_fastq_records(path))
    assert whole == list(jax_fastq.iter_fastq_records(path))
    size = os.path.getsize(path)
    for n_proc in (1, 2, 3, 5, 7, 40, 200):
        got = []
        for p in range(n_proc):
            got += list(port_fastq.iter_fastq_records_range(path, *port_fastq.byte_range_for_process(path, p, n_proc)))
        assert got == whole, n_proc
    for cut in _header_offsets(path):
        got = list(port_fastq.iter_fastq_records_range(path, 0, cut))
        got += list(port_fastq.iter_fastq_records_range(path, cut, size))
        assert got == whole, cut
    merged = {}
    for p in range(5):
        merged.update(port_fastq.load_fastq_dict_range(path, *port_fastq.byte_range_for_process(path, p, 5), 21))
    assert merged == port_fastq.load_fastq_dict(path, min_len=21)


def test_load_fastq_with_quality_equals_jax(tmp_path):
    path = _fastq_files(str(tmp_path))["at-quality"]
    got = port_fastq.load_fastq_with_quality(path, min_len=21)
    assert got == jax_fastq.load_fastq_with_quality(path, min_len=21) and len(got) > 10
    assert all(len(s) == len(q) for s, q in got.values())


def test_collectives_are_the_identity_on_a_group_of_one():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert collectives.gather_lanes(x, None) is x
    assert collectives.all_reduce_sum(x, None) is x and collectives.all_reduce_max(x, None) is x
    assert collectives.read_max(torch.tensor([5, 2, 9]), 2, None) == [5, 2, 9]


def test_mesh_of_one_needs_no_process_group():
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh == Mesh(1, 1, 0, torch.device("cpu"))
    assert (mesh.d, mesh.i, mesh.world_size) == (0, 0, 1) and mesh.describe() == "dp=1, ip=1, none"
    assert mesh.index_group is mesh.data_group is mesh.world_group is None
    with pytest.raises(ValueError):
        make_mesh(2, 1, device="cpu")
    # rank r of a (dp, ip) mesh sits at (r // ip, r % ip), as a reshape lays devices out
    grid = np.arange(6).reshape(3, 2)
    for r in range(6):
        m = Mesh(3, 2, r, torch.device("cpu"))
        assert grid[m.d, m.i] == r


def test_init_without_a_coordinator_is_single_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert init_distributed(None, 1, 0) is False
    with pytest.raises(ValueError, match="coordinator"):  # a rank of four must not run alone
        init_distributed(None, 4, 2)
    with pytest.raises(ValueError, match="not a rank"):
        init_distributed("localhost:1", 2, 2, device_type="cpu")
    with pytest.raises(ValueError, match="not a rank"):
        init_distributed("localhost:1", 2, None, device_type="cpu")
    assert pick_backend("cpu", 2) == "gloo"
    assert rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        assert pick_backend("cuda", 2) == "gloo"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device("cuda")
