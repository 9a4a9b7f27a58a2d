"""The port's CLI as several rank processes (gloo, --device cpu), mirroring
tests/test_multiprocess.py and tests/test_quantify_sharded_api.py:

  - two ranks on examples/sample.{fa,fq}, each parsing its own byte
    range, started with --coordinator flags or with torchrun's
    environment: rank 0's CSV is byte-identical to
    examples/sample.expected.csv and exactly one process writes;
  - four ranks on synthetic files with an index budget that forces the
    (2, 2) mesh, and two ranks on two samples: the CSVs equal the
    single-process runs (same rows; values within 1e-5 relative, one
    unit of the sixth printed digit, the float64 sums differing in
    order);
  - a rank whose rendezvous fails exits nonzero within its timeout and
    writes nothing;
  - --sharded in one process runs the engine at mesh (1, 1);
    --em-checkpoint with it is refused.

Every spawn has a rendezvous timeout (SKETCH_TPU_DIST_TIMEOUT) and a
join timeout, so a hang fails in seconds.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.dist.mesh import index_device_bytes
from sketch_rna_tpu_torch.index.artifact import load_index

from torch_dist_worker import free_port
from util import decode, make_transcriptome, sample_reads, write_fasta, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
JOIN_TIMEOUT_S = 300


def _spawn(args, extra_env=None):
    env = dict(os.environ, PYTHONPATH=REPO, SKETCH_TPU_DIST_TIMEOUT="120", OMP_NUM_THREADS="1")
    env.update(extra_env or {})
    return subprocess.Popen([sys.executable, "-m", "sketch_rna_tpu_torch.cli", *args], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _run_ranks(n, quant_args, launch="flags", extra_env=None):
    """Start n rank processes of one quant, wait for all; their outputs."""
    port = free_port()
    procs = []
    for rank in range(n):
        if launch == "flags":
            args = ["--coordinator", f"localhost:{port}", "--num-processes", str(n), "--process-id", str(rank)]
            env = dict(extra_env or {})
        else:  # what torchrun sets
            args = []
            env = dict(extra_env or {}, RANK=str(rank), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        procs.append(_spawn(["-o", "quant", "--device", "cpu", *args, *quant_args], env))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def _rows(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], {r[0]: [float(x) for x in r[1:]] for r in rows[1:]}


def _assert_csv_close(a, b, rtol=1e-5):
    head_a, rows_a = _rows(a)
    head_b, rows_b = _rows(b)
    assert head_a == head_b and rows_a.keys() == rows_b.keys() and len(rows_a) >= 5
    for name in rows_a:
        np.testing.assert_allclose(rows_a[name], rows_b[name], rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def sample_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("dist_cli") / "sample.npz")
    assert port_cli(["-o", "index", "--device", "cpu", os.path.join(EXAMPLES, "sample.fa"), idx]) == 0
    return idx


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 16-transcript FASTA, its two-k index and two FASTQs."""
    tmp = tmp_path_factory.mktemp("dist_cli_files")
    rng = np.random.default_rng(77)
    seqs = make_transcriptome(rng, n=16, len_range=(80, 500))
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs])
    fqs = []
    for s, n in enumerate((300, 170)):
        reads = [r for r in sample_reads(rng, seqs, n_reads=n, read_len=90, error_rate=0.01) if r.size >= 31]
        fq = str(tmp / f"s{s}.fq")
        write_fastq(fq, [f"s{s}_r{i}" for i in range(len(reads))], [decode(r) for r in reads])
        fqs.append(fq)
    idx = str(tmp / "ref.npz")
    assert port_cli(["-o", "index", "--device", "cpu", "-k", "21,31", fa, idx]) == 0
    return tmp, idx, fqs


@pytest.mark.parametrize("launch", ["flags", "torchrun-env"])
def test_two_rank_cli_writes_the_sample_csv(sample_index, tmp_path, launch):
    out_csv = str(tmp_path / "out.csv")
    outs = _run_ranks(2, [sample_index, os.path.join(EXAMPLES, "sample.fq"), out_csv], launch)
    with open(out_csv, "rb") as got, open(os.path.join(EXAMPLES, "sample.expected.csv"), "rb") as want:
        assert got.read() == want.read()
    assert sum("Output written" in o for o in outs) == 1 and "Output written" in outs[0]
    assert "quant route: sharded (dp=2, ip=1, gloo), feed: byte-range" in outs[0]
    assert "Loading index completed" not in outs[1] and "quant route" not in outs[1]


def test_four_rank_cli_on_a_2x2_mesh_equals_single(files, tmp_path):
    _, idx, fqs = files
    single, multi = str(tmp_path / "single.csv"), str(tmp_path / "multi.csv")
    assert port_cli(["-o", "quant", "--device", "cpu", "--batch-size", "64", idx, fqs[0], single]) == 0
    # A budget that one replica exceeds and half of one fits: the index axis widens to 2.
    budget = int(index_device_bytes(load_index(idx)) * 0.6)
    outs = _run_ranks(4, ["--batch-size", "64", idx, fqs[0], multi],
                      extra_env={"SKETCH_TPU_INDEX_HBM_BUDGET": str(budget)})
    assert "quant route: sharded (dp=2, ip=2, gloo), feed: byte-range" in outs[0]
    assert sum("Output written" in o for o in outs) == 1
    _assert_csv_close(single, multi)


def test_two_rank_cli_multi_sample_equals_single(files, tmp_path):
    _, idx, fqs = files
    reads = ",".join(fqs)
    assert port_cli(["-o", "quant", "--device", "cpu", "--tpm", idx, reads, str(tmp_path / "single.csv")]) == 0
    outs = _run_ranks(2, ["--tpm", idx, reads, str(tmp_path / "multi.csv")])
    assert sum(o.count("Output written") for o in outs) == 2 and outs[1].count("Output written") == 0
    for s in range(2):
        _assert_csv_close(str(tmp_path / f"single.s{s}.csv"), str(tmp_path / f"multi.s{s}.csv"))


@pytest.mark.parametrize("rank", [0, 1])
def test_failed_rendezvous_exits_nonzero(sample_index, tmp_path, rank):
    """One rank of two, alone: no silent single-process fallback."""
    out_csv = str(tmp_path / "alone.csv")
    p = _spawn(["-o", "quant", "--device", "cpu", "--coordinator", f"localhost:{free_port()}", "--num-processes", "2",
                "--process-id", str(rank), sample_index, os.path.join(EXAMPLES, "sample.fq"), out_csv],
               {"SKETCH_TPU_DIST_TIMEOUT": "3"})
    try:
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode != 0, out.decode()
    assert not os.path.exists(out_csv) and "Output written" not in out.decode()


def test_sharded_flag_in_one_process(sample_index, files, tmp_path, capsys):
    out_csv = str(tmp_path / "sharded.csv")
    fq = os.path.join(EXAMPLES, "sample.fq")
    assert port_cli(["-o", "quant", "--device", "cpu", "--sharded", sample_index, fq, out_csv]) == 0
    assert "quant route: sharded (dp=1, ip=1, none), feed:" in capsys.readouterr().err
    with open(out_csv, "rb") as got, open(os.path.join(EXAMPLES, "sample.expected.csv"), "rb") as want:
        assert got.read() == want.read()
    _, idx, fqs = files
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", idx, fqs[1], a]) == 0
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", "--sharded", idx, fqs[1], b]) == 0
    _assert_csv_close(a, b)


def test_em_checkpoint_with_sharded_is_refused(sample_index, tmp_path, capsys):
    rc = port_cli(["-o", "quant", "--device", "cpu", "--sharded", "--em-checkpoint", str(tmp_path / "em.npz"),
                   sample_index, os.path.join(EXAMPLES, "sample.fq"), str(tmp_path / "o.csv")])
    assert rc == 2 and "--em-checkpoint is not supported" in capsys.readouterr().err
    assert not (tmp_path / "o.csv").exists() and not (tmp_path / "em.npz").exists()
