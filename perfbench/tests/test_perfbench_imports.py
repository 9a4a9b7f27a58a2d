"""What runs on the card imports neither JAX nor the JAX package, and the
reference imports nothing of the port: module top-level names compared
as whole names (sketch_rna_tpu_torch begins with sketch_rna_tpu)."""

import ast
import subprocess
import sys

from perfbench.harness import FORBIDDEN
from perfbench.tests.conftest import REPO

PB = REPO / "perfbench"


def imported_tops(path):
    """The top-level names a source file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    files = [p for p in PB.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for path in files:
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        assert imported_tops(path) <= {"__future__", "hashlib", "typing", "numpy", "torch"}, path


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny cell run in a fresh interpreter, every metric reader loaded:
    afterwards no loaded module's top-level name is a forbidden one."""
    code = f"""
import json, sys
from pathlib import Path
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(2)
from perfbench import control, harness
from perfbench.tests import conftest as c
root = Path({str(tmp_path)!r})
cells = [{{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1, "why": "tests"}}]
c.write_root(root, cells, {{"tiny": c.tiny_config()}}, {{"mix": c.TINY_MIX}})
for trace in ("0", "1"):
    assert harness.main(["--workload", "tiny.mix", "--seed", "2147483999", "--seconds", "0.3", "--trace", trace],
                        root=root, device="cpu") == 0
bench = json.loads((root / "BENCHMARK.json").read_text())
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(root, m["name"])
print("TOPS", sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("TOPS")][-1]
    tops = set(eval(line[5:]))
    assert "sketch_rna_tpu_torch" in tops and "torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
