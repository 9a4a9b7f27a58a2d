"""The port's sharded quant engine over gloo rank processes on the CPU,
against the port's single-device quantify and the JAX package's
quantify_sharded.

Two groups of rank processes are spawned once (tests/torch_dist_worker.py:
2 ranks for meshes (2, 1) and (1, 2), 4 ranks for (2, 2) and (1, 4)),
each with a rendezvous timeout and a join timeout; they write every
job's result to a temp dir and each check below is its own test.

Inputs come from numpy seeds: an isoform-family transcriptome indexed by
the JAX package, reads sampled with errors.  Problems: one k (31), two ks
(21, 31), a class buffer small enough to compact and drain, and a core
that 600 transcripts share, whose reads pass 16,384 events at sketch
fraction 0.9.
Tolerances: float64 pi and weighted counts within 1e-9 relative of
quantify (summation order differs across shards; docs/PARITY.md
deviation 6 allows 5e-9) and of the JAX sharded engine on the 8 virtual
CPU devices at mesh (2, 2); has_entry, the iteration count, the mapped
read count and every loss stat equal; candidate tables equal integer for
integer to the unsharded merged grouping; every rank returns exactly
rank 0's result.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.dist.mesh import make_mesh as jax_make_mesh
from sketch_rna_tpu.index.artifact import save_index as jax_save_index
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import quantify_sharded as jax_quantify_sharded
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.mesh import make_mesh
from sketch_rna_tpu_torch.index.artifact import load_index, to_device
from sketch_rna_tpu_torch.index.shard import shard_to_device
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH
from sketch_rna_tpu_torch.pipeline import collect_pairs, match_rows, quantify, quantify_sharded

from torch_dist_worker import free_port
from util import decode, make_transcriptome, sample_reads

TESTS = os.path.dirname(os.path.abspath(__file__))
LOSS = ("sketch_overflow", "expand_dropped", "candidate_spilled", "candidate_spilled_per_k", "class_overflow",
        "wide_spilled")
JOIN_TIMEOUT_S = 600

# problem -> (seed, transcripts, tx lengths, reads, read length, error rate, config knobs)
PROBLEMS = {
    "k31": (99, 14, (60, 400), 300, 100, 0.005, dict(kmer_lengths=(31,), batch_size=64)),
    "multik": (2024, 18, (80, 600), 500, 100, 0.01,
               dict(kmer_lengths=(21, 31), batch_size=64, candidate_capacity=32)),
    "drain": (910009, 20, (60, 700), 500, 70, 0.02,
              dict(kmer_lengths=(21,), batch_size=32, stream_class_capacity=64, stream_chunk_reads=32)),
    "heavy": (160, 10, (60, 400), 120, 100, 0.005,
              dict(kmer_lengths=(31,), batch_size=64, sketch_fraction=0.9, candidate_capacity=1024)),
}
# problem -> (copies, length) of a core that many transcripts share: its
# reads pass 16,384 events, so their batches group in row slices
# (rowmatch.match_runs), cut alike on every rank of an index group.
SHARED_CORES = {"heavy": (600, 150)}
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
ALL_MESHES = [m for ms in MESHES.values() for m in ms]


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _pack(reads, pad=128):
    codes = np.zeros((len(reads), pad), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    return codes, lens


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """name -> (JAX index, index path, codes, lengths, reads path, config knobs)."""
    tmp = tmp_path_factory.mktemp("dist_problems")
    out = {}
    for name, (seed, n_tx, len_range, n_reads, read_len, err, knobs) in PROBLEMS.items():
        rng = np.random.default_rng(seed)
        seqs = make_transcriptome(rng, n=n_tx, len_range=len_range)
        if name in SHARED_CORES:
            copies, length = SHARED_CORES[name]
            core = rng.integers(0, 4, size=length).astype(np.uint8)
            seqs += [np.concatenate([f[0], core, f[1]]) for f in rng.integers(0, 4, (copies, 2, 30)).astype(np.uint8)]
        recs = JaxRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
        idx = jax_build_index(recs, JaxConfig(kmer_lengths=knobs["kmer_lengths"],
                                              sketch_fraction=knobs.get("sketch_fraction", 0.05)))
        reads = [r for r in sample_reads(rng, seqs, n_reads=n_reads, read_len=read_len, error_rate=err)
                 if r.size >= max(knobs["kmer_lengths"])]
        codes, lens = _pack(reads)
        idx_path, reads_path = str(tmp / f"{name}.idx.npz"), str(tmp / f"{name}.reads.npz")
        jax_save_index(idx_path, idx)
        np.savez(reads_path, codes=codes, lengths=lens)
        out[name] = (idx, idx_path, codes, lens, reads_path, dict(knobs, em_dtype="float64"))
    empty = str(tmp / "empty.reads.npz")
    np.savez(empty, codes=np.zeros((0, 128), np.uint8), lengths=np.zeros(0, np.int32))
    out["empty"] = (out["k31"][0], out["k31"][1], np.zeros((0, 128), np.uint8), np.zeros(0, np.int32), empty,
                    out["k31"][5])
    return out


def _plan(problems, world):
    def job(name, problem, mesh, mode, **knobs):
        _, idx_path, _, _, reads_path, cfg = problems[problem]
        return dict(name=name, index=idx_path, reads=reads_path, config=dict(cfg, **knobs), mesh=list(mesh),
                    mode=mode)

    plan = []
    for mesh in MESHES[world]:
        for problem in PROBLEMS:
            plan.append(job(f"quant-{problem}-{_tag(mesh)}", problem, mesh, "quant"))
        plan.append(job(f"step-multik-{_tag(mesh)}", "multik", mesh, "step"))
        plan.append(job(f"tables-multik-{_tag(mesh)}", "multik", mesh, "tables", match_per_k_tables=False))
    first = MESHES[world][0]
    plan.append(job(f"slice-multik-{_tag(first)}", "multik", first, "slice"))
    plan.append(job(f"empty-{_tag(first)}", "empty", first, "quant"))
    plan.append(job(f"empty-slice-{_tag(first)}", "empty", first, "slice"))
    plan.append(job(f"auto-k31-{world}", "k31", first, "auto"))
    return plan


@pytest.fixture(scope="module")
def runs(problems, tmp_path_factory):
    """job name -> the per-rank results, from both spawned groups."""
    results = {}
    groups = []
    for world in MESHES:
        workdir = str(tmp_path_factory.mktemp(f"dist_world{world}"))
        plan = _plan(problems, world)
        with open(os.path.join(workdir, "plan.json"), "w") as fh:
            json.dump(plan, fh)
        port = free_port()
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, "torch_dist_worker.py"), str(r), str(world),
                                   str(port), workdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(world)]
        groups.append((world, workdir, plan, procs))
    try:
        for world, workdir, plan, procs in groups:
            outs = []
            for p in procs:
                out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
                outs.append(out.decode())
            for r, (p, out) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, f"rank {r} of {world} failed:\n{out[-4000:]}"
            for job in plan:
                per_rank = []
                for r in range(world):
                    with np.load(os.path.join(workdir, f"{job['name']}.rank{r}.npz")) as z:
                        per_rank.append({k: z[k] for k in z.files})
                results[job["name"]] = per_rank
    finally:
        for _, _, _, procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return results


@pytest.fixture(scope="module")
def single(problems):
    """name -> the port's single-device quantify of the same reads."""
    out = {}
    for name in PROBLEMS:
        idx, _, codes, lens, _, knobs = problems[name]
        out[name] = quantify(to_device(idx, "cpu"), PackedReads(codes, lens, []), QuantConfig(**knobs))
    return out


def _assert_equals_quantify(got, ref, rtol=1e-9):
    assert int(got["iterations"]) == ref.em_iterations
    np.testing.assert_array_equal(got["has_entry"], ref.has_entry)
    assert ref.has_entry.sum() >= 5
    np.testing.assert_allclose(got["pi"], ref.pi, rtol=rtol, atol=0)
    np.testing.assert_allclose(got["weighted"], ref.weighted_counts, rtol=rtol, atol=0)
    if "num_reads" in got:
        assert int(got["num_reads"]) == ref.num_reads and int(got["num_mapped"]) == ref.num_mapped
    stats = json.loads(str(got["stats"]))
    for key in LOSS:
        if key in stats:
            assert stats[key] == ref.stats.get(key, 0) == 0, key


def _assert_replicated(per_rank):
    for other in per_rank[1:]:
        for key in ("pi", "weighted", "has_entry", "iterations"):
            np.testing.assert_array_equal(other[key], per_rank[0][key])


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
def test_sharded_equals_quantify(runs, single, mesh, problem):
    per_rank = runs[f"quant-{problem}-{_tag(mesh)}"]
    assert len(per_rank) == mesh[0] * mesh[1]
    _assert_replicated(per_rank)
    for got in per_rank:
        _assert_equals_quantify(got, single[problem])
        stats = json.loads(str(got["stats"]))
        assert all(key in stats for key in LOSS)


def test_heavy_problem_passes_the_widest_row(problems):
    """The heavy problem's core reads pass K4's widest row: a read's
    candidate scores (its events, less those of tids under the chain
    threshold) sum past 16,384."""
    idx, _, codes, lens, _, knobs = problems["heavy"]
    read, _, score, stats = collect_pairs(to_device(idx, "cpu"), PackedReads(codes, lens, []), QuantConfig(**knobs))
    assert np.bincount(read, weights=score).max() > MAX_WIDTH
    assert stats == {"sketch_overflow": 0, "expand_dropped": 0, "candidate_spilled": 0}


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
def test_small_class_buffer_compacts_and_drains(runs, mesh):
    stats = [json.loads(str(got["stats"])) for got in runs[f"quant-drain-{_tag(mesh)}"]]
    assert all(s["stream_compactions"] > 0 and s["stream_drains"] > 0 for s in stats)
    assert all(s["class_overflow"] == 0 for s in stats)


@pytest.mark.parametrize("problem", ["k31", "multik"])
def test_sharded_equals_jax_sharded(runs, problems, problem):
    """Mesh (2, 2): the port's rank processes against the JAX engine on
    four of the virtual CPU devices."""
    idx, _, codes, lens, _, knobs = problems[problem]
    jcfg = JaxConfig(max_read_len=128, **knobs)
    ref = jax_quantify_sharded(idx, JaxPacked(codes, lens, []), jcfg, mesh=jax_make_mesh(2, 2))
    got = runs[f"quant-{problem}-2x2"][0]
    assert int(got["iterations"]) == ref.em_iterations and int(got["num_reads"]) == ref.num_reads
    np.testing.assert_array_equal(got["has_entry"], ref.has_entry)
    np.testing.assert_allclose(got["pi"], ref.pi, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["weighted"], ref.weighted_counts, rtol=1e-9, atol=0)
    stats = json.loads(str(got["stats"]))
    for key in ("sketch_overflow", "expand_dropped", "candidate_spilled", "class_overflow"):
        assert stats[key] == int(np.asarray(ref.stats.get(key, 0)).sum()) == 0, key


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
def test_candidate_tables_equal_unsharded_merged(runs, problems, mesh):
    """Every rank's tables are the unsharded merged grouping's rows of its
    data shard, integer for integer (and the per-k default's, which does
    not spill here)."""
    idx, _, codes, lens, _, knobs = problems["multik"]
    dev = to_device(idx, "cpu")
    merged = QuantConfig(**dict(knobs, match_per_k_tables=False))
    for rank, got in enumerate(runs[f"tables-multik-{_tag(mesh)}"]):
        r0, r1 = (int(v) for v in got["rows"])
        assert (r0, r1) == ((len(lens) * (rank // mesh[1])) // mesh[0], (len(lens) * (rank // mesh[1] + 1)) // mesh[0])
        for cfg in (merged, QuantConfig(**knobs)):
            tid, score, _, stats = match_rows(dev, torch.from_numpy(codes[r0:r1]), lens[r0:r1], cfg)
            assert int(stats["candidate_spilled_per_k"]) == 0
            np.testing.assert_array_equal(got["tid"], tid.numpy())
            np.testing.assert_array_equal(got["score"], score.numpy())
        assert (got["score"] > 0).any(axis=1).sum() > 0.9 * (r1 - r0)
        assert json.loads(str(got["stats"]))["candidate_spilled_per_k"] == 0


@pytest.mark.parametrize("mesh", ALL_MESHES, ids=_tag)
def test_whole_batch_step_equals_quantify(runs, single, mesh):
    per_rank = runs[f"step-multik-{_tag(mesh)}"]
    for got in per_rank:
        _assert_equals_quantify(got, single["multik"])
    # replicated within a data group: ranks with the same i
    for i in range(mesh[1]):
        _assert_replicated(per_rank[i :: mesh[1]])


@pytest.mark.parametrize("world", list(MESHES))
def test_local_slices_equal_whole_read_set(runs, single, world):
    tag = _tag(MESHES[world][0])
    per_rank = runs[f"slice-multik-{tag}"]
    _assert_replicated(per_rank)
    _assert_equals_quantify(per_rank[0], single["multik"])
    np.testing.assert_array_equal(per_rank[0]["pi"], runs[f"quant-multik-{tag}"][0]["pi"])


@pytest.mark.parametrize("world", list(MESHES))
def test_auto_mesh_equals_quantify(runs, single, world):
    per_rank = runs[f"auto-k31-{world}"]
    assert len(per_rank) == world
    _assert_replicated(per_rank)
    _assert_equals_quantify(per_rank[0], single["k31"])


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("mode", ["empty", "empty-slice"])
def test_empty_reads(runs, problems, world, mode):
    idx = problems["empty"][0]
    ref = quantify(to_device(idx, "cpu"), PackedReads(np.zeros((0, 128), np.uint8), np.zeros(0, np.int32), []))
    for got in runs[f"{mode}-{_tag(MESHES[world][0])}"]:
        assert int(got["num_reads"]) == 0 and int(got["iterations"]) == 0
        assert np.isfinite(got["pi"]).all()
        np.testing.assert_array_equal(got["pi"], ref.pi)
        np.testing.assert_array_equal(got["has_entry"], ref.has_entry)


def test_index_bytes_fall_with_the_index_axis(runs, problems):
    whole = runs["quant-multik-2x1"][0]["index_bytes"]
    for mesh in [(1, 2), (2, 2), (1, 4)]:
        shards = [int(got["index_bytes"]) for got in runs[f"quant-multik-{_tag(mesh)}"]]
        assert max(shards) < 0.75 * whole * 2 / mesh[1], (mesh, shards, whole)
        # index-group shards add up to one replica (plus one row_ptr entry per extra shard and k)
        assert sum(shards[: mesh[1]]) == whole + 2 * 8 * (mesh[1] - 1)


def test_mesh_of_one_in_process_equals_quantify(problems, single):
    """quantify_sharded with no process group: the engine at mesh (1, 1)."""
    for problem in ("k31", "multik"):
        idx, idx_path, codes, lens, _, knobs = problems[problem]
        cfg = QuantConfig(**knobs)
        packed = PackedReads(codes, lens, [])
        got = quantify_sharded(load_index(idx_path), packed, cfg, device="cpu")
        ref = single[problem]
        assert got.em_iterations == ref.em_iterations and got.num_mapped == ref.num_mapped
        np.testing.assert_array_equal(got.has_entry, ref.has_entry)
        np.testing.assert_allclose(got.pi, ref.pi, rtol=1e-9, atol=0)
        np.testing.assert_allclose(got.weighted_counts, ref.weighted_counts, rtol=1e-9, atol=0)
        assert "stream_match" in got.timing and got.stats["candidate_spilled_per_k"] == 0
        # a shard passed in belongs to a mesh
        mesh = make_mesh(1, 1, device="cpu")
        shard = shard_to_device(load_index(idx_path), 1, 0, "cpu")
        again = quantify_sharded(shard, packed, cfg, mesh)
        np.testing.assert_array_equal(again.pi, got.pi)
        with pytest.raises(ValueError):
            quantify_sharded(shard, packed, cfg)


def test_checkpoint_across_ranks_is_refused(problems):
    from sketch_rna_tpu_torch.dist.mesh import Mesh
    from sketch_rna_tpu_torch.dist.quant_stream import quantify_rank

    idx, _, codes, lens, _, knobs = problems["k31"]
    cfg = dataclasses.replace(QuantConfig(**knobs), em_checkpoint="/nonexistent/em.npz")
    mesh = Mesh(1, 2, 0, torch.device("cpu"), world_group=object())
    with pytest.raises(ValueError, match="checkpoint"):  # before any collective
        quantify_rank(to_device(idx, "cpu"), PackedReads(codes, lens, []), cfg, mesh, len(lens))
