"""Helpers the port's scripts share (scale_check_torch.py and the
profile_*_torch.py scripts); imports no JAX.

  resolve_device   the torch device to run on, the card unless asked
  card             the card's name and power limit, as nvidia-smi prints them
  sync             wait for the card
  cached_index     the GENCODE-scale transcriptome's index, loaded from
                   SCALE_CACHE or built and saved there (load_gencode_index
                   holds a 250,000-transcript cache to the JAX build's digests)
  forced_streaming route every quantify through the streamed engine
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from pathlib import Path

SCALE_CACHE = Path(__file__).resolve().parent.parent / "build" / "bench_torch" / "scale_cache"


def resolve_device(device="cuda"):
    """The torch device to run on: the card unless the caller asks for the
    CPU.  Raises when a card is asked for and there is none."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return dev


def card(device) -> dict:
    """The card's name and power limit as nvidia-smi prints them ("cpu"
    and None on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        name, limit = (part.strip() for part in out.strip().splitlines()[device.index or 0].split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        import torch

        return {"name": torch.cuda.get_device_name(device), "power_limit": None}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def load_gencode_index(path: Path, ks):
    """(the cached GENCODE-scale index at `path`, None), or (None, why it
    cannot be used): missing, or some k not bit-equal to the JAX
    package's build (utils/synth.py GENCODE_INDEX), as a cache built at
    another sketch fraction or by other code would be."""
    from sketch_rna_tpu_torch.index.artifact import load_index
    from sketch_rna_tpu_torch.utils.synth import GENCODE_INDEX

    if not Path(path).exists():
        return None, (f"missing {path} (run scripts/scale_check_torch.py --transcripts 250000 "
                      f"--k {','.join(map(str, ks))})")
    artifact = load_index(str(path))
    for k in ks:
        ki = artifact.per_k.get(k)
        got = None if ki is None else (ki.num_keys, int(ki.postings.size), ki.sha256())
        if got != GENCODE_INDEX[k]:
            return None, (f"{path} at k={k} is not the GENCODE-scale index (keys, postings, sha256 {got}, "
                          f"want {GENCODE_INDEX[k]}); delete it and rerun scripts/scale_check_torch.py")
    return artifact, None


def cached_index(n_transcripts: int, ks, device, cache_dir: Path = SCALE_CACHE):
    """(the index artifact of gencode_transcriptome(n_transcripts) at ks,
    that transcriptome, where the index came from): read from cache_dir's
    T<N>_k<ks>.npz (at the GENCODE scale only if it equals the JAX
    package's build, load_gencode_index), else built on `device` and
    saved there."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import load_index, save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.utils.synth import GENCODE_TRANSCRIPTS, fasta_records, gencode_transcriptome

    seqs = gencode_transcriptome(n_transcripts)
    path = Path(cache_dir) / f"T{n_transcripts}_k{'_'.join(map(str, ks))}.npz"
    if path.exists():
        if n_transcripts != GENCODE_TRANSCRIPTS:
            return load_index(str(path)), seqs, f"index loaded from cache {path}"
        artifact, why = load_gencode_index(path, ks)
        if artifact is not None:
            return artifact, seqs, f"index loaded from cache {path}"
        print(f"not using the cache: {why}", file=sys.stderr)
    t0 = time.perf_counter()
    artifact = build_index(fasta_records(seqs), QuantConfig(kmer_lengths=tuple(ks)), device=device)
    built = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    save_index(str(path), artifact)
    return artifact, seqs, f"index built on {device} in {built:.1f}s"


@contextlib.contextmanager
def forced_streaming():
    """Routes every quantify through the streamed engine
    (pipeline.FUSED_MAX_PADDED_READS = 0)."""
    from sketch_rna_tpu_torch import pipeline

    saved = pipeline.FUSED_MAX_PADDED_READS
    pipeline.FUSED_MAX_PADDED_READS = 0
    try:
        yield
    finally:
        pipeline.FUSED_MAX_PADDED_READS = saved
