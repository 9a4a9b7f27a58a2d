"""The comparison that decides `correct`: its arithmetic, the control (the
program's float32 EM) failing it, and whole runs with the timed path
broken underneath coming out not correct, once for each fault a cell of
this benchmark can have.  (Every cell runs on one chip: there is no
exchange between chips to leave out.)"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import check, control, harness
from perfbench.tests.conftest import REPO, last_line

SEED = str(2**31 + 777)


def result(pi, w, has=None, mapped=5):
    pi, w = np.asarray(pi, float), np.asarray(w, float)
    return {"pi": pi, "weighted_counts": w, "has_entry": w > 0 if has is None else np.asarray(has),
            "num_mapped": mapped}


def test_compare_readings():
    ref = result([0.5, 2.0, 0.01], [0.0, 4.0, 0.5])
    assert check.compare(ref, ref) == {name: 0.0 for name in check.NUMBERS}
    got = check.compare(result([0.5, 2.0 * (1 + 1e-6), 0.01], [0.0, 4.0, 0.5 + 1e-3], mapped=7), ref)
    assert got["pi_rel_err"] == pytest.approx(1e-6) and got["counts_err"] == pytest.approx(1e-3)
    assert got["num_mapped_diff"] == 2 and got["has_entry_diff"] == 0
    assert check.compare(result([0.5, 2.0, 0.01], [0.0, 4.0, 0.5], has=[True, True, True]), ref)["has_entry_diff"] == 1
    assert check.compare(result([1.0], [1.0]), ref)["pi_rel_err"] == float("inf")


def test_worst_and_verdict():
    a = dict.fromkeys(check.NUMBERS, 0.0)
    b = dict(a, pi_rel_err=float("nan"))
    limits = json.loads((REPO / "perfbench" / "limits" / "gencode250k_k31.fused_1m.json").read_text())
    assert check.verdict(check.worst([a]), limits)
    assert not check.verdict(check.worst([a, b]), limits)
    assert not check.verdict(dict(a, num_mapped_diff=1.0), limits)
    assert set(check.lines(a, limits)) == set(check.NUMBERS)


def tightest(name):
    return min(json.loads(p.read_text())[name] for p in (REPO / "perfbench" / "limits").glob("*.json"))


def test_control_fails_the_limits_and_the_program_meets_them(tiny_root):
    rows = list(control.readings(tiny_root, "tiny.mix", [2**31 + 1, 2**31 + 2], [2**31 + 1], device="cpu"))
    program = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control"]
    assert len(program) == 2 and len(ctrl) == 1
    loosest = {n: max(json.loads(p.read_text())[n] for p in (REPO / "perfbench" / "limits").glob("*.json"))
               for n in check.NUMBERS}
    assert all(r[n] <= tightest(n) for r in program for n in check.NUMBERS)
    assert ctrl[0]["pi_rel_err"] > loosest["pi_rel_err"] and ctrl[0]["counts_err"] > loosest["counts_err"]


def run_broken(root, capsys):
    rc = harness.main(["--workload", "tiny.mix", "--seed", SEED, "--seconds", "0.3", "--trace", "0"], root=root,
                      device="cpu")
    assert rc == 0
    out, err = last_line(capsys)
    return out


def test_unbroken_run_is_correct(tiny_root, capsys):
    assert run_broken(tiny_root, capsys)["correct"] is True


def test_em_that_leaves_its_state_unchanged(tiny_root, capsys, monkeypatch):
    from sketch_rna_tpu_torch import pipeline

    real = pipeline.run_em_tables
    monkeypatch.setattr(pipeline, "run_em_tables",
                        lambda tables, num_reads, max_iterations, **kw: real(tables, num_reads, max_iterations=0, **kw))
    out = run_broken(tiny_root, capsys)
    assert out["correct"] is False and out["checks"]["pi_rel_err"]["value"] > 1e-3


def test_half_of_the_reads_left_out(tiny_root, capsys, monkeypatch):
    from sketch_rna_tpu_torch import pipeline

    real = pipeline.quantify

    def half(index, packed, config=None):
        n = packed.num_reads // 2
        return real(index, dataclasses.replace(packed, codes=packed.codes[:n], lengths=packed.lengths[:n]), config)

    monkeypatch.setattr(pipeline, "quantify", half)
    out = run_broken(tiny_root, capsys)
    assert out["correct"] is False and out["checks"]["num_mapped_diff"]["value"] > 0


def test_one_answer_altered_where_it_is_produced(tiny_root, capsys, monkeypatch):
    from sketch_rna_tpu_torch import pipeline

    real = pipeline.match_scan

    def altered(index, codes, lengths, config, **kw):
        tid, score, n_padded, stats = real(index, codes, lengths, config, **kw)
        row = int(torch.nonzero(score[:, 0] > 0)[0, 0])
        tid[row, 0] = (tid[row, 0] + 1) % index.num_transcripts  # one read's best candidate, moved
        return tid, score, n_padded, stats

    monkeypatch.setattr(pipeline, "match_scan", altered)
    out = run_broken(tiny_root, capsys)
    assert out["correct"] is False
