"""The port's profiling tooling on the CPU: utils/profiling.py's pure parts
and the six scripts/profile_*_torch.py, at small sizes.

- busy_share's interval union, whole_calls' grouping, the trace-retake
  rule, host_ops' counts (a CUDA graph's replay one launch) and op_name,
  on synthetic records;
- profile_step_torch's stage chain equals the port's sketch_match_step
  and the JAX package's collect_pairs on the same reads; its scan row
  reports match_scan per batch;
- every posterior-sum strategy of profile_em_scatter_torch equals
  index_add_ within 1e-12, and one EM iteration built on it equals the
  JAX package's run_em_tables within 1e-12 (float64);
- profile_multik_torch's per-k sorts + merge equal one sort, int32 and
  int64; profile_sketch_torch's three routes agree bit for bit;
- profile_feed_torch counts every read of a 5,000-read FASTQ and
  profile_stream_torch's --resident run equals the uploaded one;
- each script's last line is its JSON, and each refuses to run on the
  CPU unless --device cpu is passed.
"""

import csv
import json
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.em.em import run_em_tables as jax_run_em_tables
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import collect_pairs as jax_collect_pairs
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import save_index, to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.utils import profiling
from sketch_rna_tpu_torch.utils.synth import fasta_records, gencode_transcriptome, sample_reads, write_fastq

from util import decode

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))

import profile_em_scatter_torch  # noqa: E402
import profile_feed_torch  # noqa: E402
import profile_multik_torch  # noqa: E402
import profile_sketch_torch  # noqa: E402
import profile_step_torch  # noqa: E402
import profile_stream_torch  # noqa: E402

CPU = torch.device("cpu")
CUDA = torch.autograd.DeviceType.CUDA
HOST = torch.autograd.DeviceType.CPU


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The scripts time many small calls: one intra-op thread keeps them
    from contending for the cores with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ev(name="k", start=0, end=1, device=CUDA, parent=None):
    """A record with the fields the profiling helpers read."""
    return SimpleNamespace(name=name, device_type=device, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start))


@pytest.mark.parametrize("spans,busy_us", [
    ([(0, 10), (5, 15), (12, 20)], 20),  # overlapping
    ([(0, 100), (10, 20), (30, 40), (90, 100)], 100),  # nested
    ([(0, 10), (20, 30), (50, 51)], 21),  # disjoint
    ([(40, 50), (0, 10), (5, 45)], 50),  # unsorted, bridged
], ids=["overlapping", "nested", "disjoint", "bridged"])
def test_busy_share_is_the_union_of_intervals(spans, busy_us):
    busy_s, share = profiling.busy_share([_ev(start=a, end=b) for a, b in spans], 200e-6)
    assert busy_s == pytest.approx(busy_us / 1e6)
    assert share == pytest.approx(busy_us / 200)
    assert profiling.busy_share([], 1.0) == (0.0, 0.0)


def test_whole_calls_keeps_the_runs_of_the_usual_length():
    mark = profiling.MARK
    names = [mark, "a", "b", mark, "a", "b", mark, "a", mark, "a", "b", mark]  # call 3 lost a record
    events = [_ev(n, start=i, end=i + 1) for i, n in enumerate(names)]
    calls = profiling.whole_calls(events[::-1])  # any order: sorted by start
    assert [[e.name for e in run] for run in calls] == [["a", "b"]] * 3
    assert profiling.whole_calls([_ev("a")]) == []
    # a lost mark merges two calls into one run, which is left out
    merged = [_ev(n, start=i, end=i + 1) for i, n in enumerate([mark, "a", "b", "a", "b", mark, "a", "b", mark,
                                                                  "a", "b", mark])]
    assert [len(run) for run in profiling.whole_calls(merged)] == [2, 2]


def test_retake_keeps_the_fullest_trace():
    takes = iter([[1] * 3, [1] * 7, [1] * 5, [1] * 6, [1] * 2, [1] * 7, [1], [1] * 4, [1] * 9])
    best, counts = profiling.retake(lambda: next(takes), len, lambda got: len(got) >= 9)
    assert counts == [3, 7, 5, 6, 2, 7, 1, 4] and len(best) == 7  # eight tries at most; the first of the fullest
    takes = iter([[1] * 3, [1] * 9, [1] * 2])
    best, counts = profiling.retake(lambda: next(takes), len, lambda got: len(got) >= 9)
    assert counts == [3, 9] and len(best) == 9  # stops once one is full enough


def test_host_ops_counts_per_call():
    aten = _ev("aten::add", device=HOST)
    events = [aten, _ev("aten::empty", device=HOST, parent=aten), _ev("aten::mul", device=HOST),
              *[_ev(n, device=HOST, parent=aten) for n in ("cudaLaunchKernel", "cudaLaunchKernel", "cuLaunchKernel",
                                                          "cudaMemcpyAsync", "cudaMemsetAsync",
                                                          "cudaStreamSynchronize", "cudaMalloc", "cudaFree")],
              _ev("cudaLaunchKernel", device=CUDA)]  # a device record is not a host call
    assert profiling.host_ops(events, calls=2) == {"launch": 1.5, "memcpy": 1.0, "sync": 0.5, "alloc": 1.0,
                                                   "torch_ops": 1.0}


def test_host_ops_counts_a_graph_replay_as_a_launch():
    """A CUDA graph's replay is one host launch, whichever API made it."""
    events = [_ev(n, device=HOST) for n in ("cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchKernel")]
    assert profiling.host_ops(events)["launch"] == 3


@pytest.mark.parametrize("name,want", [
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<double, long>(double*, long)",
     "at::native::indexFuncLargeIndex"),
    ("fused_sketch_kernel(unsigned char const*, int const*)", "fused_sketch_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_op_name_drops_templates_and_arguments(name, want):
    assert profiling.op_name(name) == want
    got = profiling.device_ms_by_name([_ev(name, 0, 1500), _ev(name, 2000, 2500), _ev("x", 0, 10)], top=1)
    assert got == [(want, 2.0, 2)]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """60 transcripts of the GENCODE-scale generator, both indexes (k = 31
    and (21, 31)) built on the CPU and saved, and 600 reads of 150 bp
    (seed 7, padded to 256) also written as a FASTQ."""
    tmp = tmp_path_factory.mktemp("profile")
    seqs = gencode_transcriptome(60)
    indexes = {}
    for ks in ((31,), (21, 31)):
        artifact = build_index(fasta_records(seqs), QuantConfig(kmer_lengths=ks), device="cpu")
        save_index(str(tmp / f"T60_k{'_'.join(map(str, ks))}.npz"), artifact)
        indexes[ks] = to_device(artifact, "cpu")
    codes, lengths = sample_reads(seqs, 600, 150, 256, seed=7)
    write_fastq(str(tmp / "reads.fq"), codes, lengths)
    return SimpleNamespace(tmp=tmp, seqs=seqs, indexes=indexes, codes=codes, lengths=lengths)


@pytest.mark.parametrize("ks", [(31,), (21, 31)], ids=["k31", "k21_31"])
def test_stage_chain_equals_step_and_jax_collect_pairs(problem, ks):
    index = problem.indexes[ks]
    B = 512
    config = QuantConfig(kmer_lengths=ks, batch_size=B)
    c, n, caps = profile_step_torch.first_batch(index, problem.codes, problem.lengths, B)
    calls, chained = profile_step_torch.stage_calls(index, config, c, n, caps)
    whole = calls["step"]()
    for field in ("tid", "score", "mask"):
        assert torch.equal(getattr(chained, field), getattr(whole, field)), field
    # The JAX package on the same reads, as one batch cut to the same width.
    L = c.shape[1]
    names = [f"T{i}" for i in range(len(problem.seqs))]
    jcfg = JaxConfig(kmer_lengths=ks, batch_size=B, max_read_len=L, expand_per_read=1 << 12)
    jidx = jax_build_index(JaxRecords(names, [decode(s) for s in problem.seqs], 0), jcfg)
    jpacked = JaxPacked(np.ascontiguousarray(problem.codes[:B, :L]), problem.lengths[:B], [str(i) for i in range(B)])
    j_read, j_tid, j_score, j_stats = jax_collect_pairs(jidx, jpacked, jcfg)
    score = chained.score.numpy()
    row, col = np.nonzero(score > 0)
    np.testing.assert_array_equal(row, j_read)
    np.testing.assert_array_equal(chained.tid.numpy()[row, col], j_tid)
    np.testing.assert_array_equal(score[row, col], j_score)
    assert j_read.size > B and j_stats["expand_dropped"] == 0


@pytest.mark.parametrize("ks", [(31,), (21, 31)], ids=["k31", "k21_31"])
def test_scan_row_per_batch(problem, ks):
    """profile_step_torch's scan row: match_scan over every read, per batch
    (device time not measured on the CPU, no graph captured there)."""
    index = problem.indexes[ks]
    config = QuantConfig(kmer_lengths=ks, batch_size=128)
    row = profile_step_torch.profile_scan(index, config, problem.codes, problem.lengths)
    assert row["batches"] == 5 and row["device_ms"] is None and row["wall_ms"] > 0
    assert row["graphs_a_call"] == 0 and row["syncs_a_call"] == {} and row["launches"] == {}
    assert 0 < row["host_ops"]["torch_ops"] and row["host_ops"]["launch"] == 0
    for split in row["split_ms"].values():
        parts = split["to_read"] + split["read"] + split["after_read"] + split["drain"]
        assert min(split.values()) >= 0 and parts == pytest.approx(split["total"])


@pytest.fixture(scope="module")
def em_table(problem):
    """The fused engine's EM tables of the 600 reads at k = 31 (batches of
    512: 1,024 padded reads, so equivalence classes in width tiers)."""
    index = problem.indexes[(31,)]
    tables, _, _ = profile_step_torch.class_tables(index, QuantConfig(batch_size=512), problem.codes,
                                                   problem.lengths)
    assert len(tables) > 1
    return tables, index.num_transcripts


@pytest.mark.parametrize("strategy", profile_em_scatter_torch.STRATEGIES)
def test_em_strategy_equals_index_add_and_jax_iteration(em_table, strategy):
    tables, T = em_table
    R = 600
    flat_tid = torch.cat([t[0].long().reshape(-1) for t in tables])
    fns, _, _ = profile_em_scatter_torch.strategies(flat_tid, T, torch.cat([(t[1] > 0).reshape(-1) for t in tables]))
    pi0 = torch.full((T,), 1.0 / T, dtype=torch.float64)
    values = profile_step_torch.flat_posteriors(tables, pi0)
    ps = fns[strategy](values)
    assert profile_em_scatter_torch.rel_err(ps, fns["index_add"](values)) <= 1e-12
    # one EM iteration on this sum (em/em.py's M-step) against the JAX package's
    pcf = torch.tensor(0.01, dtype=torch.float32)
    pi1 = (ps + (pcf / torch.tensor(float(R), dtype=torch.float32)).double()) + pcf.double()
    tid, score, weight = profile_em_scatter_torch.single_layout(tables)  # the JAX function takes one table
    j_pi, j_it = jax_run_em_tables(jnp.asarray(tid.numpy()), jnp.asarray(score.numpy()), jnp.asarray(R, jnp.int32),
                                   num_transcripts=T, max_iterations=1, dtype="float64",
                                   weight=jnp.asarray(weight.numpy().astype(np.int32)))
    assert int(j_it) == 1
    assert profile_em_scatter_torch.rel_err(pi1, torch.from_numpy(np.array(j_pi))) <= 1e-12


def test_em_scatter_profile_checks_and_chains(em_table):
    tables, T = em_table
    out = profile_em_scatter_torch.profile_scatter(tables, T, CPU, chained=True)
    assert out["lanes"] == sum(t[0].numel() for t in tables) and len(out["tables"]) == len(tables)
    assert set(out["strategies"]) == set(profile_em_scatter_torch.STRATEGIES)
    assert out["segsum_bit_stable"] and out["segsum_equals_plain"]
    assert all(s["device_ms"] is None and s["max_rel_err"] <= 1e-12 for s in out["strategies"].values())
    assert all(out["chained"][s]["max_rel_err"] <= 1e-12 for s in profile_em_scatter_torch.STRATEGIES)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_per_k_sorts_and_merge_equal_one_sort(dtype):
    rng = np.random.default_rng(5)
    hi = 2**31 - 2 if dtype == torch.int32 else 2**40
    parts = [torch.from_numpy(rng.integers(0, hi, size=(96, w))).to(dtype) for w in (32, 64)]
    parts[0][:, 20:] = 2**31 - 1  # sentinel tails, as expanded rows end
    out = profile_multik_torch.sort_both_ways(parts, CPU)
    assert out["equal"] and out["shape"] == [96, 128] and out["dtype"] == str(dtype)[6:]
    assert out["per_k_merge"]["wall_ms"] > 0 and out["one_sort"]["device_ms"] is None


@pytest.mark.parametrize("ks,L", [((31,), 104), ((21, 31), 300)], ids=["k31-104", "k21_31-300"])
def test_sketch_routes_agree_bit_for_bit(ks, L):
    out = profile_sketch_torch.profile_width(48, L, ks, CPU)
    assert out["equal"] and out["shape"] == [48, L] and set(profile_sketch_torch.ROUTES) <= set(out)


def test_feed_counts_every_read(tmp_path):
    path = tmp_path / "reads.fq"
    codes, lengths = sample_reads(gencode_transcriptome(30), 5000, 150, 152, seed=9)
    write_fastq(str(path), codes, lengths)
    out = profile_feed_torch.profile_feed(str(path), 1024, 31, 256, CPU, upload=False)
    assert out["reads"] == 5000 and out["fastq_bytes"] == os.path.getsize(path)
    assert out["upload_pinned"] is None and out["upload_stream"] is None  # no card: not measured
    assert all(out[s]["reads_per_s"] > 0 for s in ("scan", "pack8", "pack2", "pipeline"))


def _rows(path):
    with open(path) as fh:
        return {r[0]: [float(x) for x in r[1:]] for r in list(csv.reader(fh))[1:]}


def test_stream_resident_csv_equals_uploaded(problem, capsys):
    idx = str(problem.tmp / "T60_k31.npz")
    out = str(problem.tmp / "stream.csv")
    assert profile_stream_torch.main([idx, str(problem.tmp / "reads.fq"), "--csv", out, "--chunk-reads", "256",
                                      "--resident", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    a, b = _rows(out), _rows(out + ".resident.csv")
    assert a.keys() == b.keys() and len(a) > 10
    assert max(abs(x - y) / max(abs(y), 1e-300) for k in a for x, y in zip(a[k], b[k])) <= 1e-12
    assert line["resident"]["max_rel_diff"] <= 1e-12 and len(line["chunks"]) == 3
    assert line["reads"] == 600 and line["resident"]["stream_match_split"]["upload_s"] >= 0


def _script_args(name, problem):
    tmp, fq = str(problem.tmp), str(problem.tmp / "reads.fq")
    return {
        "profile_step_torch": ["--transcripts", "60", "--ks", "31", "--reads", "600", "--batch", "256",
                               "--cache-dir", tmp],
        "profile_multik_torch": ["--transcripts", "60", "--reads", "600", "--batch", "32", "--cache-dir", tmp],
        "profile_em_scatter_torch": ["2000", "8", "300"],
        "profile_sketch_torch": ["32", "104", "31"],
        "profile_feed_torch": [fq, "--chunk", "256", "--batch", "256"],
        "profile_stream_torch": [str(problem.tmp / "T60_k31.npz"), fq, "--chunk-reads", "256"],
    }[name]


_METRICS = {"profile_step_torch": "profile_step", "profile_multik_torch": "multik_stages",
            "profile_em_scatter_torch": "em_scatter", "profile_sketch_torch": "sketch_routes",
            "profile_feed_torch": "host_feed", "profile_stream_torch": "stream_file_to_result"}


@pytest.mark.parametrize("name", sorted(_METRICS))
def test_script_last_line_is_its_json(name, problem, capsys):
    assert sys.modules[name].main(_script_args(name, problem) + ["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == _METRICS[name]
    if name == "profile_step_torch":
        assert all(set(run["scan"]) >= {"wall_ms", "device_ms", "host_ops", "graphs_a_call"} for run in line["runs"])
    assert line["card"] == {"name": "cpu", "power_limit": None}


@pytest.mark.parametrize("name", sorted(_METRICS))
def test_script_refuses_the_cpu_unless_asked(name, problem, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sys.modules[name].main(_script_args(name, problem)) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err
