"""The transcriptome and program-index cache under perfbench/.cache/ in the
checkout (gitignored).

A cell's first run in a checkout synthesises the configuration's
transcriptome, builds the program's index from it on the run's device
(the port's build_index, what a user's `-o index` runs) and writes both
here; later runs load them, as a user's `-o quant` loads its index.  A
file is used only when its digests equal the ones the configuration file
freezes: a stale or foreign file is rebuilt and replaced, never used.
Each file has a fixed name and is written under a fixed temporary name
and renamed into place.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from perfbench import gen
from perfbench.reference.quant import index_digest


def cache_dir(root: Path) -> Path:
    return Path(root) / "perfbench" / ".cache"


def transcriptome_digest(flat: np.ndarray, lengths: np.ndarray) -> str:
    """sha256 over the lengths (int32, little-endian) | the codes (uint8)."""
    h = hashlib.sha256(np.ascontiguousarray(lengths, "<i4").tobytes())
    h.update(np.ascontiguousarray(flat, np.uint8).tobytes())
    return h.hexdigest()


def _pack2(flat: np.ndarray) -> np.ndarray:
    q = np.concatenate([flat, np.zeros(-flat.size % 4, np.uint8)]).reshape(-1, 4)
    return q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)


def _unpack2(packed: np.ndarray, n: int) -> np.ndarray:
    return ((packed[:, None] >> (np.arange(4, dtype=np.uint8) * 2)) & 3).reshape(-1)[:n]


def _replace(path: Path, write) -> None:
    """write(a path) under a fixed temporary name beside path, then rename
    it into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".partial")
    write(str(tmp))
    os.replace(tmp, path)


def _savez(path: str, **arrays) -> None:
    with open(path, "wb") as fh:  # a file object: np.savez adds no ".npz"
        np.savez(fh, **arrays)


def transcriptome(root: Path, cfg: Dict) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(flat codes [M] uint8, lengths [T] int32, True if read from the
    cache) of the configuration's transcriptome, checked against
    cfg["transcriptome_sha256"]."""
    recipe = cfg["transcriptome"]
    key = hashlib.sha256(repr(sorted(recipe.items())).encode()).hexdigest()[:16]
    path = cache_dir(root) / f"transcriptome_{key}.npz"
    want = cfg["transcriptome_sha256"]
    if path.exists():
        try:
            with np.load(path, allow_pickle=False) as z:
                lengths = z["lengths"]
                flat = _unpack2(z["codes2"], int(lengths.astype(np.int64).sum()))
            if transcriptome_digest(flat, lengths) == want:
                return flat, lengths, True
        except (OSError, ValueError, KeyError):
            pass
    flat, lengths = gen.transcriptome(recipe, Path(root) / "perfbench" / "configs")
    got = transcriptome_digest(flat, lengths)
    if got != want:
        raise RuntimeError(f"transcriptome digest {got} is not the configuration's {want}")
    _replace(path, lambda tmp: _savez(tmp, codes2=_pack2(flat), lengths=lengths))
    return flat, lengths, False


def index_ok(idx, cfg: Dict) -> bool:
    """Does an IndexArtifact hold the configuration's index: its ks, its
    transcripts and each k's frozen (keys, postings, sha256)?"""
    q = cfg["quant"]
    if tuple(idx.kmer_lengths) != tuple(q["kmer_lengths"]) or len(idx.names) != cfg["transcriptome"]["transcripts"]:
        return False
    if float(idx.sketch_fraction) != q["sketch_fraction"]:
        return False
    for k in q["kmer_lengths"]:
        keys, postings, sha = cfg["index_digests"][str(k)]
        ki = idx.per_k[k]
        if ki.keys.size != keys or ki.postings.size != postings or index_digest(ki.keys, ki.row_ptr, ki.postings) != sha:
            return False
    return True


def program_index(root: Path, cfg: Dict, flat: np.ndarray, lengths: np.ndarray, device) -> Tuple[object, bool]:
    """(the program's IndexArtifact of the configuration, True if loaded
    from the cache): loaded with the port's load_index, or built with its
    build_index on `device` and saved with its save_index."""
    from sketch_rna_tpu_torch.config import QuantConfig
    from sketch_rna_tpu_torch.index.artifact import load_index, save_index
    from sketch_rna_tpu_torch.index.build import build_index
    from sketch_rna_tpu_torch.io.fasta import FastaRecords

    q = cfg["quant"]
    path = cache_dir(root) / f"index_{cfg['name']}.npz"
    if path.exists():
        try:
            idx = load_index(str(path))
            if index_ok(idx, cfg):
                return idx, True
        except (OSError, ValueError, KeyError):
            pass
    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    text = np.frombuffer(b"ACGT", np.uint8)[flat].tobytes().decode()
    names = [f"T{i:06d}" for i in range(lengths.size)]
    records = FastaRecords(names, [text[offs[i] : offs[i + 1]] for i in range(lengths.size)], 0)
    idx = build_index(records, QuantConfig(kmer_lengths=tuple(q["kmer_lengths"]),
                                           sketch_fraction=q["sketch_fraction"]), device=device)
    if not index_ok(idx, cfg):
        got = {k: (ki.keys.size, ki.postings.size, index_digest(ki.keys, ki.row_ptr, ki.postings))
               for k, ki in idx.per_k.items()}
        raise RuntimeError(f"the program's index {got} is not the configuration's {cfg['index_digests']}")
    _replace(path, lambda tmp: save_index(tmp, idx))
    return idx, False

