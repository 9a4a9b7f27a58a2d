"""The PyTorch port imports neither JAX, nor the JAX package, nor Triton.

The machine with the GPU has no JAX, and the JAX package is the
reference the port is checked against, so the port must stand alone.
Run in a subprocess so the test session's own imports don't count.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import sketch_rna_tpu_torch
import sketch_rna_tpu_torch.cli
import sketch_rna_tpu_torch.pipeline
import sketch_rna_tpu_torch.index.build
import sketch_rna_tpu_torch.utils.synth
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu", "triton"))
assert not bad, bad
print("PORT-IMPORT-CLEAN")
"""


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
