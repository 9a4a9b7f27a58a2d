"""FASTA parsing with the reference's exact record semantics.

Mirrors load_fasta (reference src/data_io.cpp:47-80):
  - a record header is a line starting '>'; the ID is the header text up
    to the first space (only ' ' delimits, not tabs),
  - multi-line sequences are concatenated verbatim,
  - empty lines are skipped,
  - records whose sequence contains non-ACGT characters are dropped.

Like the JAX package, every record is validated (the reference skips
the last one), real lengths are kept, and duplicate IDs keep the first
record in input order.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List

from sketch_rna_tpu_torch.io.packing import is_valid_sequence


def open_maybe_gzip(path: str):
    """Open text, transparently decompressing gzip (magic 1f 8b)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


@dataclasses.dataclass
class FastaRecords:
    names: List[str]  # insertion order (first occurrence wins on dup IDs)
    seqs: List[str]  # aligned with names
    n_invalid: int  # records dropped for non-ACGT content

    def __len__(self) -> int:
        return len(self.names)


def load_fasta(path: str) -> FastaRecords:
    names: List[str] = []
    seqs: List[str] = []
    index: Dict[str, int] = {}
    n_invalid = 0

    def flush(cur_id: str, parts: List[str]) -> None:
        nonlocal n_invalid
        if not cur_id:
            return
        seq = "".join(parts)
        if not is_valid_sequence(seq):
            n_invalid += 1
            return
        if cur_id in index:
            return  # duplicate header: the reference's emplace keeps the first
        index[cur_id] = len(names)
        names.append(cur_id)
        seqs.append(seq)

    cur_id = ""
    parts: List[str] = []
    with open_maybe_gzip(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == ">":
                flush(cur_id, parts)
                rest = line[1:]
                sp = rest.find(" ")
                cur_id = rest if sp < 0 else rest[:sp]
                parts = []
            else:
                parts.append(line)
    flush(cur_id, parts)
    return FastaRecords(names, seqs, n_invalid)
