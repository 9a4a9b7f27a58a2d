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
        "sketch_rna_tpu_torch.utils.roofline", "sketch_rna_tpu_torch.oracle.fuzz"} <= set(names), names
sys.argv = ["chip_smoke.py"]
import chip_smoke
# every kernel wrapper's launch count exists from import on, at 0
assert all(getattr(obj, attr) == 0 for obj, attr in chip_smoke.counters().values()), chip_smoke.counters()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu", "triton"))
assert not bad, bad
print("PORT-IMPORT-CLEAN")
"""


# The port's scripts, which run on the machine with the GPU.
_PROFILE_SCRIPTS = ("profile_step_torch.py", "profile_multik_torch.py", "profile_em_scatter_torch.py",
                    "profile_sketch_torch.py", "profile_feed_torch.py", "profile_stream_torch.py")
_SCRIPTS = [os.path.join(_REPO, "scripts", n) for n in ("fuzz_oracle_torch.py", "evaluate_accuracy_torch.py",
                                                        "scale_check_torch.py", "make_fastq_torch.py",
                                                        "common_torch.py", *_PROFILE_SCRIPTS)]


def _sources():
    """Every Python source of the port, chip_smoke.py and the port's
    scripts."""
    out = [os.path.join(_REPO, "chip_smoke.py")] + _SCRIPTS
    for root, _, names in os.walk(os.path.join(_REPO, "sketch_rna_tpu_torch")):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return out


def test_port_sources_name_no_jax_import():
    """No source line imports jax or the JAX package, lazily or not (the
    probe below sees only what importing the modules pulls in)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sketch_rna_tpu)(\.|\s|$)", re.M)
    sources = _sources()
    assert len(sources) > 30 and any(p.endswith(os.path.join("dist", "mesh.py")) for p in sources)
    assert all(os.path.exists(p) for p in _SCRIPTS)
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
# roofline, 8-bit chunk feed and oracle fuzz: each alone, in a fresh
# interpreter.
_ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu"))
assert not bad, bad
print("ALONE-CLEAN")
"""


@pytest.mark.parametrize("module", ["sketch_rna_tpu_torch.oracle", "sketch_rna_tpu_torch.match.candidates",
                                    "sketch_rna_tpu_torch.utils.roofline", "sketch_rna_tpu_torch.io.native",
                                    "sketch_rna_tpu_torch.oracle.fuzz"])
def test_new_module_alone_imports_no_jax(module):
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _ALONE, module], env=env, capture_output=True, timeout=300,
                         cwd=_REPO)
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "ALONE-CLEAN" in out.stdout.decode()


# Each script run in a fresh interpreter on the CPU at a tiny size: it
# works without JAX, and running it imports none.
_SCRIPT_RUN = """
import runpy, sys
path, args = sys.argv[1], sys.argv[2:]
sys.argv = [path] + args
try:
    runpy.run_path(path, run_name="__main__")
except SystemExit as exc:
    assert not exc.code, exc.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sketch_rna_tpu"))
assert not bad, bad
print("SCRIPT-CLEAN")
"""


@pytest.mark.parametrize("script,args", [
    ("fuzz_oracle_torch.py", ["1", "--device", "cpu"]),
    ("evaluate_accuracy_torch.py", ["--transcripts", "20", "--reads", "300", "--device", "cpu"]),
    ("scale_check_torch.py", ["--transcripts", "60", "--reads", "500", "--device", "cpu", "--cache-dir", "{tmp}"]),
    ("make_fastq_torch.py", ["{tmp}/reads.fq", "--transcripts", "60", "--reads", "500", "--chunk", "200"]),
], ids=["fuzz", "accuracy", "scale-check", "make-fastq"])
def test_script_runs_without_jax(script, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=_REPO)
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    out = subprocess.run([sys.executable, "-c", _SCRIPT_RUN, os.path.join(_REPO, "scripts", script)] + args,
                         env=env, capture_output=True, timeout=300, cwd=_REPO)
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "SCRIPT-CLEAN" in out.stdout.decode()


@pytest.fixture(scope="module")
def profile_inputs(tmp_path_factory):
    """A 30-transcript k = 31 index and a 300-read FASTQ, made by the port."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import fasta_records, gencode_transcriptome, sample_reads, write_fastq

    tmp = tmp_path_factory.mktemp("profile_scripts")
    seqs = gencode_transcriptome(30)
    save_index(str(tmp / "T30_k31.npz"), build_index(fasta_records(seqs), QuantConfig(), device="cpu"))
    write_fastq(str(tmp / "reads.fq"), *sample_reads(seqs, 300, 150, 152, seed=4))
    return tmp


@pytest.mark.parametrize("script,args", [
    ("profile_step_torch.py", ["--transcripts", "30", "--reads", "300", "--batch", "128", "--cache-dir", "{tmp}"]),
    ("profile_multik_torch.py", ["--transcripts", "30", "--reads", "300", "--batch", "32", "--cache-dir", "{tmp}"]),
    ("profile_em_scatter_torch.py", ["1000", "8", "200", "--chained"]),
    ("profile_sketch_torch.py", ["16", "104", "31"]),
    ("profile_feed_torch.py", ["{tmp}/reads.fq", "--chunk", "128", "--batch", "128"]),
    ("profile_stream_torch.py", ["{tmp}/T30_k31.npz", "{tmp}/reads.fq", "--chunk-reads", "128", "--resident"]),
], ids=["step", "multik", "em-scatter", "sketch", "feed", "stream"])
def test_profile_script_runs_without_jax(script, args, profile_inputs):
    # One intra-op thread: the scripts time many small calls, which
    # contend badly for the cores with the suite's other workers.
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    args = [a.replace("{tmp}", str(profile_inputs)) for a in args] + ["--device", "cpu"]
    out = subprocess.run([sys.executable, "-c", _SCRIPT_RUN, os.path.join(_REPO, "scripts", script)] + args,
                         env=env, capture_output=True, timeout=300, cwd=_REPO)
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "SCRIPT-CLEAN" in out.stdout.decode()


def test_no_card_raises(monkeypatch):
    """Asked for the card (the scripts' default) where there is none,
    common_torch.resolve_device raises; it never carries on on the CPU."""
    import torch

    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    import common_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common_torch.resolve_device(device)
    assert common_torch.resolve_device("cpu").type == "cpu"


# Each script that takes its card from common_torch, run without a card
# and without --device cpu: it exits 2 and says there is no CUDA device.
@pytest.mark.parametrize("script,args", [
    ("scale_check_torch.py", []),
    ("profile_step_torch.py", ["--transcripts", "30", "--reads", "300", "--batch", "128", "--cache-dir", "{tmp}"]),
    ("profile_multik_torch.py", ["--transcripts", "30", "--reads", "300", "--batch", "32", "--cache-dir", "{tmp}"]),
    ("profile_em_scatter_torch.py", ["1000", "8", "200", "--chained"]),
    ("profile_sketch_torch.py", ["16", "104", "31"]),
    ("profile_feed_torch.py", ["{tmp}/reads.fq", "--chunk", "128", "--batch", "128"]),
    ("profile_stream_torch.py", ["{tmp}/T30_k31.npz", "{tmp}/reads.fq", "--chunk-reads", "128", "--resident"]),
], ids=["scale-check", "step", "multik", "em-scatter", "sketch", "feed", "stream"])
def test_scripts_without_a_card_exit_nonzero(script, args, request):
    if "{tmp}" in " ".join(args):
        tmp = str(request.getfixturevalue("profile_inputs"))
        args = [a.replace("{tmp}", tmp) for a in args]
    env = dict(os.environ, PYTHONPATH=_REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join("scripts", script), *args], env=env, capture_output=True,
                         text=True, timeout=300, cwd=_REPO)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr and "metric" not in out.stdout
