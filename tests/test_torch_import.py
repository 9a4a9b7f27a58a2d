"""The PyTorch port imports neither JAX, nor the JAX package, nor Triton.

The machine with the GPU has no JAX, and the JAX package is the
reference the port is checked against, so the port must stand alone.
Run in a subprocess so the test session's own imports don't count.
"""

import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import sketch_rna_tpu_torch
import sketch_rna_tpu_torch.cli
import sketch_rna_tpu_torch.pipeline
import sketch_rna_tpu_torch.index.build
import sketch_rna_tpu_torch.utils.synth
import importlib, pkgutil
names = [m.name for m in pkgutil.walk_packages(sketch_rna_tpu_torch.__path__, "sketch_rna_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"sketch_rna_tpu_torch.dist.quant_stream", "sketch_rna_tpu_torch.dist.collectives",
        "sketch_rna_tpu_torch.utils.profiling", "sketch_rna_tpu_torch.index.shard",
        "sketch_rna_tpu_torch.oracle.reference_oracle", "sketch_rna_tpu_torch.match.candidates",
        "sketch_rna_tpu_torch.utils.roofline"} <= set(names), names
sys.argv = ["chip_smoke.py"]
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu", "triton"))
assert not bad, bad
print("PORT-IMPORT-CLEAN")
"""


def _sources():
    """Every Python source of the port, and chip_smoke.py."""
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "sketch_rna_tpu_torch")):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return out


def test_port_sources_name_no_jax_import():
    """No source line imports jax or the JAX package, lazily or not (the
    probe below sees only what importing the modules pulls in)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sketch_rna_tpu)(\.|\s|$)", re.M)
    sources = _sources()
    assert len(sources) > 30 and any(p.endswith(os.path.join("dist", "mesh.py")) for p in sources)
    for path in sources:
        with open(path) as fh:
            hits = pattern.findall(fh.read())
        assert not hits, (path, hits)


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env=env,
        capture_output=True,
        timeout=300,
        cwd=_REPO,
    )
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "PORT-IMPORT-CLEAN" in out.stdout.decode()


# The modules that carry the JAX package's oracle, global-sort matcher,
# roofline and 8-bit chunk feed: each alone, in a fresh interpreter.
_ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu"))
assert not bad, bad
print("ALONE-CLEAN")
"""


@pytest.mark.parametrize("module", ["sketch_rna_tpu_torch.oracle", "sketch_rna_tpu_torch.match.candidates",
                                    "sketch_rna_tpu_torch.utils.roofline", "sketch_rna_tpu_torch.io.native"])
def test_new_module_alone_imports_no_jax(module):
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _ALONE, module], env=env, capture_output=True, timeout=300,
                         cwd=_REPO)
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "ALONE-CLEAN" in out.stdout.decode()
