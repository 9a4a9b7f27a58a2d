"""A tiny checkout for the CPU tests: BENCHMARK.json and the data files of
one small cell under a temporary root, the metric readers copied from
this folder, digests computed by the reference; and the `card` marker of
tests that need a CUDA device (they decide inside a fixture)."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import cache, gen  # noqa: E402
from perfbench.reference import quant as ref  # noqa: E402

TINY_TX = {"generator": "synth_transcriptome", "seed": 7, "transcripts": 300, "len_lo": 120, "len_hi": 400,
           "iso_frac": 0.6}
TINY_MIX = {"reads": 3000, "read_len": 100, "abundance_sigma": 1.5, "substitution_rate": 0.01, "off_target": 0.1,
            "packing": "codes", "pool": 2, "warmup_samples": 1, "trace_samples": 1, "check_samples": 2}
LIMITS = {"pi_rel_err": 1e-9, "counts_err": 1e-9, "has_entry_diff": 0, "num_mapped_diff": 0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tiny_config(ks=(31,)):
    flat, lengths = gen.transcriptome(TINY_TX)
    idx = ref.build_index(torch.from_numpy(flat), torch.from_numpy(lengths), ks, 0.05)
    digests = {str(k): [idx[k][0].numel(), idx[k][2].numel(), ref.index_digest(*idx[k])] for k in ks}
    return {"source": "tests", "transcriptome": TINY_TX,
            "transcriptome_sha256": cache.transcriptome_digest(flat, lengths),
            "quant": {"kmer_lengths": list(ks), "sketch_fraction": 0.05, "chain_fraction": 0.9,
                      "em_max_iterations": 20, "em_convergence": 0.01, "em_dtype": "float64", "batch_size": 1024},
            "index_digests": digests, "assumed": [], "reduced": []}


def write_root(root: Path, cells, configs, mixes, e2e=None, per_layer=None) -> Path:
    """A checkout-like root: BENCHMARK.json, the given data files, and this
    folder's metric readers."""
    pb = root / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE.parent / "metrics", pb / "metrics", dirs_exist_ok=True)
    for name, c in configs.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, m in mixes.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(m))
    for cell in cells:
        (pb / "limits" / f"{cell['name']}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = cells
    names = [c["name"] for c in cells]
    bench["end_to_end"] = e2e or [dict(m, workloads=names) for m in bench["end_to_end"]]
    bench["per_layer"] = per_layer or [dict(m, workloads=names) for m in bench["per_layer"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_cfg():
    return tiny_config()


@pytest.fixture
def tiny_root(tmp_path, tiny_cfg):
    cells = [{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1, "why": "tests"}]
    return write_root(tmp_path, cells, {"tiny": tiny_cfg}, {"mix": TINY_MIX})


def last_line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def seeded(n=2**31 + 12345):
    return np.random.default_rng(n)
