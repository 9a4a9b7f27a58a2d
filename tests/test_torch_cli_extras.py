"""The port's CLI routes and single-device extras against the JAX package.

  - the streamed route (forced in both packages by patching
    FUSED_MAX_PADDED_READS to 0) through each read feed: native scan,
    native background scan, Python parser; same CSV as the JAX CLI's
    (row set equal, float64 values within 1e-9 relative);
  - multi-sample quant with a TPM column: same file names and contents
    as the JAX CLI's, TPM equal to a numpy recompute;
  - the reference-binary index: byte-equal to the JAX writer's, read
    back equal, detected by load_any_index;
  - EM checkpoints: a run killed mid-EM and resumed equals the one-shot
    run, on the fused and streamed engines, and a checkpoint written by
    either package resumes in the other.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import sketch_rna_tpu.pipeline as jax_pipeline
import sketch_rna_tpu_torch.pipeline as port_pipeline
from sketch_rna_tpu.cli import main as jax_cli
from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.index.refbin import write_refbin_index as jax_write_refbin
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu_torch.cli import main as port_cli
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.em.checkpoint import EMState, check_resumable, fingerprint_of, load_em_state, save_em_state
from sketch_rna_tpu_torch.em.em import run_em_tables
from sketch_rna_tpu_torch.index.artifact import load_index, to_device
from sketch_rna_tpu_torch.index.refbin import is_npz_index, load_any_index, read_refbin_index, write_refbin_index
from sketch_rna_tpu_torch.io import native
from sketch_rna_tpu_torch.io.packing import PackedReads

from util import decode, make_transcriptome, sample_reads, write_fasta, write_fastq

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _rows(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], {r[0]: [float(x) for x in r[1:]] for r in rows[1:]}


def _assert_csv_close(a, b, rtol=1e-9):
    head_a, rows_a = _rows(a)
    head_b, rows_b = _rows(b)
    assert head_a == head_b
    assert rows_a.keys() == rows_b.keys() and len(rows_a) >= 5
    for name in rows_a:
        np.testing.assert_allclose(rows_a[name], rows_b[name], rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 14-transcript FASTA, its npz index (JAX-built), and two FASTQs."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(404)
    seqs = make_transcriptome(rng, n=14, len_range=(80, 500))
    names = [f"T{i}" for i in range(len(seqs))]
    fa = str(tmp / "ref.fa")
    write_fasta(fa, names, [decode(s) for s in seqs])
    fqs = []
    for s, n in enumerate((260, 140)):
        reads = sample_reads(rng, seqs, n_reads=n, read_len=90, error_rate=0.01)
        fq = str(tmp / f"sample{s}.fq")
        write_fastq(fq, [f"s{s}_r{i}" for i in range(len(reads))], [decode(r) for r in reads])
        fqs.append(fq)
    idx = str(tmp / "ref.npz")
    assert jax_cli(["-o", "index", fa, idx]) == 0
    return tmp, fa, idx, fqs, seqs, names


@pytest.mark.parametrize("feed", ["native-scan", "native-lazy", "python"])
def test_cli_streamed_route_equals_jax_cli(files, tmp_path, monkeypatch, capsys, feed):
    tmp, _, idx, fqs, _, _ = files
    if feed != "python" and not native.native_available():
        pytest.skip(f"native fastio library did not build ({native.so_path()})")
    monkeypatch.setattr(port_pipeline, "FUSED_MAX_PADDED_READS", 0)
    monkeypatch.setattr(jax_pipeline, "FUSED_MAX_PADDED_READS", 0)
    monkeypatch.setenv("SKETCH_TPU_STREAM_MIN_BYTES", "0" if feed == "native-lazy" else str(2 << 30))
    extra = ["--no-native"] if feed == "python" else []
    knobs = ["--batch-size", "64", "--stream-chunk-reads", "128", "--em-dtype", "float64"]
    port_out, jax_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    capsys.readouterr()
    assert port_cli(["-o", "quant", "--device", "cpu", *knobs, *extra, idx, fqs[0], port_out]) == 0
    assert f"quant route: streamed, feed: {feed}" in capsys.readouterr().err
    assert jax_cli(["-o", "quant", *knobs, *extra, idx, fqs[0], jax_out]) == 0
    _assert_csv_close(port_out, jax_out)


def test_cli_fused_route_is_named(files, tmp_path, capsys):
    _, _, idx, fqs, _, _ = files
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", idx, fqs[1], str(tmp_path / "o.csv")]) == 0
    assert "quant route: fused, feed: python" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [("--expand-per-read", "256")])
def test_jax_only_flags_are_accepted_and_ignored(files, tmp_path, capsys, flag, value):
    """A JAX command line runs in the port: the flags of machinery the
    port leaves out are no-ops, each named in one line on stderr."""
    _, _, idx, fqs, _, _ = files
    plain, flagged = str(tmp_path / "plain.csv"), str(tmp_path / "flagged.csv")
    assert port_cli(["-o", "quant", "--device", "cpu", idx, fqs[1], plain]) == 0
    assert "accepted and ignored" not in capsys.readouterr().err
    assert port_cli(["-o", "quant", "--device", "cpu", flag, value, idx, fqs[1], flagged]) == 0
    notes = [ln for ln in capsys.readouterr().err.splitlines() if "accepted and ignored" in ln]
    assert len(notes) == 1 and flag in notes[0]
    assert open(plain, "rb").read() == open(flagged, "rb").read()
    assert jax_cli(["-o", "quant", flag, value, idx, fqs[1], str(tmp_path / "jax.csv")]) == 0


@pytest.mark.parametrize("flags,route", [([], "scatter"), (["--em-segsum", "on"], "segsum"),
                                         (["--em-segsum", "off"], "scatter"), (["--em-mxu", "auto"], "scatter"),
                                         (["--em-mxu", "on", "--em-dtype", "float32"], "scatter"),
                                         (["--em-mxu", "on", "--em-segsum", "on"], "scatter")])
def test_cli_em_routes_on_the_sample(tmp_path, capsys, flags, route):
    """The JAX CLI's --em-segsum / --em-mxu run (as tests/test_end_to_end.py
    checks them there): the route line names the EM route, and --em-mxu on,
    whose one-hot step the port does not have, says on one line of its own
    that it takes the scatter route; float64 routes write the sample CSV
    byte for byte, float32 within 1e-4 relative."""
    idx, out = str(tmp_path / "s.npz"), str(tmp_path / "o.csv")
    assert port_cli(["-o", "index", "--device", "cpu", os.path.join(EXAMPLES, "sample.fa"), idx]) == 0
    capsys.readouterr()
    assert port_cli(["-o", "quant", "--device", "cpu", *flags, idx, os.path.join(EXAMPLES, "sample.fq"), out]) == 0
    err = capsys.readouterr().err.splitlines()
    lines = [ln for ln in err if ln.startswith("quant route:")]
    assert len(lines) == 1 and lines[0].endswith(f", em: {route}"), lines
    notes = [ln for ln in err if ln.startswith("--em-mxu on:")]
    assert len(notes) == (flags[:2] == ["--em-mxu", "on"])
    expected = os.path.join(EXAMPLES, "sample.expected.csv")
    if "float32" in flags:
        _assert_csv_close(out, expected, rtol=1e-4)
    else:
        assert open(out, "rb").read() == open(expected, "rb").read()


@pytest.mark.parametrize("engine", ["streamed", "sharded", "checkpointed"])
def test_cli_segsum_engines_equal_fused(files, tmp_path, monkeypatch, capsys, engine):
    """--em-segsum on through the streamed engine, the sharded engine
    (mesh (1, 1)) and a checkpointed EM equals the fused default-route
    run within 1e-9, and each names the segsum route."""
    _, _, idx, fqs, _, _ = files
    fused = str(tmp_path / "fused.csv")
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", idx, fqs[0], fused]) == 0
    extra = {"streamed": ["--batch-size", "64", "--stream-chunk-reads", "128"], "sharded": ["--sharded"],
             "checkpointed": ["--em-checkpoint", str(tmp_path / "em.npz")]}[engine]
    if engine == "streamed":
        monkeypatch.setattr(port_pipeline, "FUSED_MAX_PADDED_READS", 0)
    out = str(tmp_path / "seg.csv")
    capsys.readouterr()
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", "--em-segsum", "on", *extra, idx, fqs[0],
                     out]) == 0
    route = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("quant route:")]
    assert len(route) == 1 and route[0].endswith(", em: segsum")
    assert ("sharded" in route[0]) == (engine == "sharded") and ("streamed" in route[0]) == (engine == "streamed")
    _assert_csv_close(out, fused)


@pytest.mark.parametrize("engine", ["fused", "sharded"])
@pytest.mark.parametrize("flags", [[], ["--em-segsum", "on"], ["--em-segsum", "off"]])
def test_cli_route_line_names_the_route_taken(files, tmp_path, monkeypatch, capsys, engine, flags):
    """The route line's EM route is the one em_route takes for the quant's
    tables (on the CPU: segsum only with --em-segsum on)."""
    _, _, idx, fqs, _, _ = files
    taken = []
    real = port_pipeline.em_route

    def em_route(tables, num_transcripts, config):
        route = real(tables, num_transcripts, config)
        taken.append("segsum" if route["use_segsum"] else "scatter")
        return route

    monkeypatch.setattr(port_pipeline, "em_route", em_route)
    capsys.readouterr()
    extra = ["--sharded"] if engine == "sharded" else []
    assert port_cli(["-o", "quant", "--device", "cpu", "--no-native", *flags, *extra, idx, fqs[0],
                     str(tmp_path / "o.csv")]) == 0
    route = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("quant route:")]
    assert len(taken) == 1 and route == [route[0].rsplit(", em: ", 1)[0] + f", em: {taken[0]}"]
    assert taken[0] == ("segsum" if flags == ["--em-segsum", "on"] else "scatter")


def test_multi_sample_tpm_equals_jax_cli(files, tmp_path):
    _, _, idx, fqs, _, _ = files
    reads = ",".join(fqs)
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        assert cli(["-o", "quant", *extra, "--tpm", "--em-dtype", "float64", idx, reads,
                    str(tmp_path / f"{name}.csv")]) == 0
    lengths = load_index(idx).lengths.astype(np.float64)
    names = load_index(idx).names
    for s in range(2):
        port, jax_csv = tmp_path / f"port.sample{s}.csv", tmp_path / f"jax.sample{s}.csv"
        assert port.exists() and jax_csv.exists()
        _assert_csv_close(str(port), str(jax_csv))
        head, rows = _rows(str(port))
        assert head == ["Name", "NumReads", "EM_Abundance", "TPM"]
        counts = np.zeros(len(names))
        for n, (c, _, _) in rows.items():
            counts[names.index(n)] = c
        rate = counts / np.maximum(lengths, 1.0)
        tpm = rate / rate.sum() * 1e6
        for n, (_, _, t) in rows.items():
            assert abs(t - tpm[names.index(n)]) <= 1e-5 * tpm[names.index(n)] + 1e-9
        # Each sample's CSV equals its single-sample run.
        single = tmp_path / f"single{s}.csv"
        assert port_cli(["-o", "quant", "--device", "cpu", "--tpm", "--em-dtype", "float64", idx, fqs[s],
                         str(single)]) == 0
        assert port.read_bytes() == single.read_bytes()


def test_refbin_bytes_equal_jax_and_load_any(files, tmp_path):
    _, fa, idx, _, seqs, names = files
    art = load_index(idx)
    text = [decode(s) for s in seqs]
    port_bin, jax_bin = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    write_refbin_index(port_bin, art, text)
    jax_write_refbin(jax_bin, jax_build_index(JaxRecords(names, text, 0), JaxConfig()), text)
    assert open(port_bin, "rb").read() == open(jax_bin, "rb").read()
    back = read_refbin_index(port_bin)
    assert back.names == art.names and back.kmer_lengths == art.kmer_lengths
    np.testing.assert_array_equal(back.lengths, art.lengths)
    for k in art.kmer_lengths:
        for field in ("keys", "row_ptr", "postings"):
            np.testing.assert_array_equal(getattr(back.per_k[k], field), getattr(art.per_k[k], field))
    assert is_npz_index(idx) and not is_npz_index(port_bin)
    assert load_any_index(port_bin).names == load_any_index(idx).names
    # The CLI writes the same bytes, and quant reads either format alike.
    cli_bin = str(tmp_path / "cli.bin")
    assert port_cli(["-o", "index", "--device", "cpu", "--index-format", "refbin", fa, cli_bin]) == 0
    assert open(cli_bin, "rb").read() == open(jax_bin, "rb").read()


def test_sample_refbin_quant_byte_identical(tmp_path):
    fa, fq = os.path.join(EXAMPLES, "sample.fa"), os.path.join(EXAMPLES, "sample.fq")
    idx, out = str(tmp_path / "s.bin"), str(tmp_path / "s.csv")
    assert port_cli(["-o", "index", "--device", "cpu", "--index-format", "refbin", fa, idx]) == 0
    assert port_cli(["-o", "quant", "--device", "cpu", "--em-dtype", "float64", idx, fq, out]) == 0
    with open(out, "rb") as a, open(os.path.join(EXAMPLES, "sample.expected.csv"), "rb") as b:
        assert a.read() == b.read()


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        port_cli(["--version"])
    assert e.value.code == 0 and "sketch-rna-tpu-torch" in capsys.readouterr().out


# --- EM checkpoints (mirrors tests/test_checkpoint.py) ----------------------


def test_resume_reproduces_oneshot():
    rng = np.random.default_rng(0xC0FFEE)
    tid = torch.from_numpy(rng.integers(0, 40, size=(200, 8)).astype(np.int32))
    score = torch.from_numpy(rng.integers(0, 5, size=(200, 8)).astype(np.int32))
    kw = dict(num_transcripts=40, convergence_threshold=1e-9, dtype="float64")
    tables = [(tid, score, None)]
    pi_full, it_full, done_full = run_em_tables(tables, 180, max_iterations=20, **kw)
    pi_half, it_half, done_half = run_em_tables(tables, 180, max_iterations=10, **kw)
    assert it_half == 10 and not done_half
    pi_res, it_res, _ = run_em_tables(tables, 180, max_iterations=20, init_pi=pi_half, start_iteration=it_half, **kw)
    assert it_res == it_full
    assert torch.equal(pi_res, pi_full)


def test_state_roundtrip_and_fingerprint(tmp_path):
    pi = np.random.default_rng(1).random(64)
    cfg = QuantConfig()
    fp = fingerprint_of(64, 1000, cfg)
    assert fp == jax_fingerprint(64, 1000, JaxConfig())
    path = str(tmp_path / "em.ckpt.npz")
    save_em_state(path, EMState(pi=pi, iterations_done=7, num_reads=1000, fingerprint=fp))
    loaded = load_em_state(path)
    np.testing.assert_array_equal(loaded.pi, pi)
    assert (loaded.iterations_done, loaded.num_reads) == (7, 1000)
    check_resumable(loaded, fp)
    with pytest.raises(ValueError):
        check_resumable(loaded, fingerprint_of(65, 1000, cfg))


def jax_fingerprint(*args):
    from sketch_rna_tpu.em.checkpoint import fingerprint_of as fp

    return fp(*args)


@pytest.fixture(scope="module")
def ckpt_problem():
    rng = np.random.default_rng(31337)
    seqs = make_transcriptome(rng, n=12, len_range=(60, 400))
    recs = JaxRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    idx = jax_build_index(recs, JaxConfig(kmer_lengths=(31,)))
    reads = [r for r in sample_reads(rng, seqs, n_reads=200, read_len=90) if r.size >= 31]
    codes = np.zeros((len(reads), 128), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    return idx, codes, lens


@pytest.mark.parametrize("engine", ["fused", "streamed"])
def test_quantify_kill_and_resume(ckpt_problem, tmp_path, monkeypatch, engine):
    idx, codes, lens = ckpt_problem
    if engine == "streamed":
        monkeypatch.setattr(port_pipeline, "FUSED_MAX_PADDED_READS", 0)
    dev = to_device(idx, "cpu")
    packed = PackedReads(codes, lens, [])
    cfg = QuantConfig(batch_size=64, em_dtype="float64")
    oneshot = port_pipeline.quantify(dev, packed, cfg)
    assert oneshot.em_iterations > 7  # the kill point is mid-run
    ckpt = str(tmp_path / "em.ckpt.npz")
    port_pipeline.quantify(dev, packed, dataclasses.replace(cfg, em_max_iterations=7, em_checkpoint=ckpt,
                                                            em_checkpoint_every=3))
    assert load_em_state(ckpt).iterations_done == 7
    resumed = port_pipeline.quantify(dev, packed, dataclasses.replace(cfg, em_checkpoint=ckpt, em_checkpoint_every=3))
    np.testing.assert_array_equal(resumed.pi, oneshot.pi)
    np.testing.assert_array_equal(resumed.weighted_counts, oneshot.weighted_counts)
    assert resumed.em_iterations == oneshot.em_iterations


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(ckpt_problem, tmp_path, writer):
    """A checkpoint one package writes after 7 iterations resumes in the
    other; the result equals the resuming package's one-shot run within
    float64 summation-order drift."""
    idx, codes, lens = ckpt_problem
    dev = to_device(idx, "cpu")
    jcfg = JaxConfig(kmer_lengths=(31,), batch_size=64, max_read_len=128, em_dtype="float64")
    cfg = QuantConfig(batch_size=64, em_dtype="float64")
    ckpt = str(tmp_path / "em.ckpt.npz")
    if writer == "jax":
        jax_pipeline.quantify(idx, JaxPacked(codes, lens, []), dataclasses.replace(
            jcfg, em_max_iterations=7, em_checkpoint=ckpt, em_checkpoint_every=3))
        assert load_em_state(ckpt).iterations_done == 7
        oneshot = port_pipeline.quantify(dev, PackedReads(codes, lens, []), cfg)
        resumed = port_pipeline.quantify(dev, PackedReads(codes, lens, []),
                                         dataclasses.replace(cfg, em_checkpoint=ckpt, em_checkpoint_every=3))
    else:
        port_pipeline.quantify(dev, PackedReads(codes, lens, []), dataclasses.replace(
            cfg, em_max_iterations=7, em_checkpoint=ckpt, em_checkpoint_every=3))
        oneshot = jax_pipeline.quantify(idx, JaxPacked(codes, lens, []), jcfg)
        resumed = jax_pipeline.quantify(idx, JaxPacked(codes, lens, []),
                                        dataclasses.replace(jcfg, em_checkpoint=ckpt, em_checkpoint_every=3))
    assert int(resumed.em_iterations) == int(oneshot.em_iterations) > 7
    np.testing.assert_array_equal(resumed.has_entry, oneshot.has_entry)
    np.testing.assert_allclose(resumed.pi, oneshot.pi, rtol=1e-9, atol=0)
    np.testing.assert_allclose(resumed.weighted_counts, oneshot.weighted_counts, rtol=1e-9, atol=0)


def test_cli_em_checkpoint_resume_byte_identical(tmp_path):
    """The sample through the CLI, stopped after 2 EM iterations and
    resumed from its checkpoint, writes the one-shot run's bytes."""
    fa, fq = os.path.join(EXAMPLES, "sample.fa"), os.path.join(EXAMPLES, "sample.fq")
    idx, ckpt = str(tmp_path / "s.npz"), str(tmp_path / "em.ckpt.npz")
    base = ["-o", "quant", "--device", "cpu", "--em-dtype", "float64"]
    assert port_cli(["-o", "index", "--device", "cpu", fa, idx]) == 0
    assert port_cli([*base, idx, fq, str(tmp_path / "oneshot.csv")]) == 0
    assert port_cli([*base, "--em-max-iterations", "2", "--em-checkpoint", ckpt, idx, fq,
                     str(tmp_path / "killed.csv")]) == 0
    assert load_em_state(ckpt).iterations_done == 2
    assert port_cli([*base, "--em-checkpoint", ckpt, idx, fq, str(tmp_path / "resumed.csv")]) == 0
    assert (tmp_path / "resumed.csv").read_bytes() == (tmp_path / "oneshot.csv").read_bytes()
