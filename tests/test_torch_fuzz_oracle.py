"""The port's conformance scripts on the CPU.

  - sketch_rna_tpu_torch.oracle.fuzz (scripts/fuzz_oracle_torch.py's
    trials): the first trial of each of its eight
    regimes (seeds 777000 .. 777007, as chip_smoke's fuzz phase starts)
    holds the port to the oracle with every kernel's plain version; its
    generators equal the JAX package's test generators (tests/util.py)
    draw for draw, so its draws are the JAX script's; its main exits
    nonzero without a card unless told --device cpu;
  - scripts/evaluate_accuracy_torch.py prints the JAX package's
    scripts/evaluate_accuracy.py line on the same arguments.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import util

from sketch_rna_tpu_torch.oracle import fuzz

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("i", range(len(fuzz.REGIMES)), ids=list(fuzz.REGIMES))
def test_first_trial_of_each_regime(i):
    info = fuzz.one_trial(777000 + i, "cpu", fuzz.REGIMES[i])
    assert "skipped" not in info, info
    assert info["regime"] == fuzz.REGIMES[i] and info["pairs"] > 0
    assert info["pi_rel"] <= 1e-12 and info["numreads_rel"] <= 1e-12


def test_regimes_fix_what_they_name():
    for i, regime in enumerate(fuzz.REGIMES):
        d = fuzz.draw(777000 + i)  # seed mod 8 picks the regime
        assert d["regime"] == regime
        ks, knobs = d["knobs"]["kmer_lengths"], d["knobs"]
        lengths = [r.size for r in d["reads"]]
        assert {"fused-1k": len(ks) == 1, "fused-mk": len(ks) in (2, 3), "nine-ks": len(ks) == 9,
                "sharded": d["engine"] == "sharded" and len(ks) > 1,
                "streamed": d["engine"] == "streamed" and knobs["stream_class_capacity"] == 16,
                "segsum": knobs["em_segsum"] == "on", "long": min(lengths) > 1024 + max(ks) - 1,
                "very-long": knobs["sketch_fraction"] == 0.9 and min(lengths) >= 19500}[regime], (regime, d)


@pytest.mark.parametrize("seed", [3, 777000])
def test_generators_are_the_jax_tests(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    seqs = fuzz.make_transcriptome(a, n=9, len_range=(40, 800))
    want = util.make_transcriptome(b, n=9, len_range=(40, 800))
    assert all(np.array_equal(x, y) for x, y in zip(seqs, want)) and len(seqs) == len(want)
    got = fuzz.sample_reads(a, seqs, n_reads=50, read_len=90)
    want = util.sample_reads(b, want, n_reads=50, read_len=90)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert a.random() == b.random()


def _run(args):
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + args, env=env, capture_output=True, text=True, timeout=600, cwd=_REPO)


@pytest.mark.parametrize("script", ["fuzz_oracle_torch.py", "evaluate_accuracy_torch.py"])
def test_script_refuses_without_a_card(script):
    out = _run([os.path.join("scripts", script)])
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_accuracy_line_equals_jax_script():
    args = ["--transcripts", "60", "--reads", "3000", "--read-len", "120", "--seed", "5"]
    want = _run([os.path.join("scripts", "evaluate_accuracy.py")] + args)
    got = _run([os.path.join("scripts", "evaluate_accuracy_torch.py"), "--device", "cpu"] + args)
    assert want.returncode == 0 and got.returncode == 0, want.stderr + got.stderr
    line = got.stdout.strip().splitlines()[-1]
    assert line.startswith("transcripts=60 reads=3000 spearman=")
    assert line == want.stdout.strip().splitlines()[-1]
