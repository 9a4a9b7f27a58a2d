"""A whole run of a tiny cell on the CPU: the result line's keys, a new
configuration, traffic mix and metric found as files alone, the cells'
metric lists, the exits without a card and with JAX loaded."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import REPO, TINY_MIX, last_line, tiny_config, write_root

SEED = str(2**31 + 4321)


def run(root, trace=0, seconds="0.5", workload="tiny.mix"):
    return harness.main(["--workload", workload, "--seed", SEED, "--seconds", seconds, "--trace", str(trace)],
                        root=root, device="cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(tiny_root, capsys, trace):
    assert run(tiny_root, trace) == 0
    out, err = last_line(capsys)
    assert list(out)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in harness.cell_metrics(bench, "tiny.mix", bool(trace))}
    # Off the card the device's numbers are not measured, and a fused sample has no
    # streamed stage: those readers return nothing.
    unread = {"device_mem_peak_GiB", "device_mem_reserved_GiB", "device.reserved_MiB_per_sample",
              "sketch_kernel_roofline", "device.idle_share", "stream.match_ms_per_mreads"}
    assert set(out["metrics"]) == wanted - unread
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # The numbers compared are the last lines of standard error, each beside its limit.
    tail = err.strip().splitlines()[-4:]
    assert [line.split()[1] for line in tail] == list(out["checks"])
    assert all(" limit " in line for line in tail)


def test_new_config_mix_and_metric_as_files(tmp_path, capsys, tiny_cfg, monkeypatch):
    from sketch_rna_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "FUSED_MAX_PADDED_READS", 0)  # the tiny 2-bit samples stream, as 2^23 reads do
    cells = [{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1, "why": "tests"},
             {"name": "tiny_mk.stream2", "config": "tiny_mk", "traffic": "stream2", "chips": 1, "why": "tests"}]
    mix2 = dict(TINY_MIX, packing="2bit", read_len=120, read_len_min=60)
    root = write_root(tmp_path, cells, {"tiny": tiny_cfg, "tiny_mk": tiny_config((21, 31))},
                      {"mix": TINY_MIX, "stream2": mix2})
    (root / "perfbench" / "metrics" / "reads_total.py").write_text(
        "def read(run):\n    return sum(s.reads for s in run.samples)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "reads_total", "unit": "reads", "better": "higher", "source": "host_clock",
                               "layer": "window", "moves": "reads_per_s", "workloads": ["tiny_mk.stream2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run(root, 1, workload="tiny_mk.stream2") == 0
    out, _ = last_line(capsys)
    assert out["correct"] is True
    assert out["metrics"]["reads_total"]["value"] == out["attempted"] * TINY_MIX["reads"]
    assert "stream.match_ms_per_mreads" in out["metrics"] and "match.ms_per_mreads" not in out["metrics"]
    assert run(root, 1, workload="tiny.mix") == 0
    assert "reads_total" not in last_line(capsys)[0]["metrics"]


def test_cell_metrics_follow_workloads_and_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in harness.cell_metrics(bench, "y", False)] == ["a"]
    assert [m["name"] for m in harness.cell_metrics(bench, "x", True)] == ["p", "q"]
    assert [m["name"] for m in harness.cell_metrics(bench, "y", True)] == ["p", "r"]


def test_benchmark_files_name_each_other():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = REPO / "perfbench"
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        assert (pb / "configs" / f"{w['config']}.json").exists() and (pb / "traffic" / f"{w['traffic']}.json").exists()
        assert (pb / "limits" / f"{w['name']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").exists()
        assert all(w in {c["name"] for c in bench["workloads"]} for w in m.get("workloads", []))


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gencode250k_k31.fused_1m", "--seed",
                           SEED, "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_package_exits(tmp_path):
    (tmp_path / "perfbench").mkdir()
    (tmp_path / "perfbench" / "run.py").write_text((REPO / "perfbench" / "run.py").read_text())
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gencode250k_k31.fused_1m", "--seed",
                           SEED, "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_jax_loaded_exits_without_a_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "sketch_rna_tpu.pipeline", sys.modules["json"])
    assert run(tiny_root) == 4
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err and "sketch_rna_tpu.pipeline" in out.err


def test_jax_loaded_after_the_window_exits_without_a_result(tiny_root, tmp_path, capsys, monkeypatch):
    """A metric reader, which runs after the window, loads a module named
    jax (a stub): the run still prints no result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    assert "jax" not in sys.modules
    (tiny_root / "perfbench" / "metrics" / "loads_jax.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_jax", "unit": "ops", "better": "lower", "source": "host_clock",
                               "layer": "tests", "moves": "reads_per_s", "workloads": ["tiny.mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        assert run(tiny_root, trace=1) == 4
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sketch_rna_tpu_torch_extra", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jaxtyping", sys.modules["json"])
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys.modules["json"])
    assert harness.forbidden_modules() == ["flax.linen"]


@pytest.mark.card
def test_a_cell_on_the_card(card, capsys):
    assert harness.main(["--workload", "gencode250k_k31.fused_1m", "--seed", SEED, "--seconds", "3", "--trace", "1"],
                        root=REPO) == 0
    out, _ = last_line(capsys)
    assert out["correct"] is True and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


def test_benchmark_json_keeps_to_the_contract():
    import re

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith("perfbench/") and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert name.match(w["name"]) and name.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == len(e2e) + len(bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024
