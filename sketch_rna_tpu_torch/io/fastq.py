"""FASTQ parsing with the reference's exact single-pass record semantics.

Mirrors process_fastq_single_pass (reference src/main.cpp:107-151):
  - any line starting '@' is a record header; the next three lines are
    sequence, '+' separator (ignored) and quality,
  - lines between records that don't start '@' are skipped,
  - the read ID is the FULL header minus '@' (src/main.cpp:122),
  - only records that pass validation are inserted into the id map, so
    the LAST VALID occurrence of an ID wins (src/main.cpp:132-150).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from sketch_rna_tpu_torch.io.fasta import open_maybe_gzip
from sketch_rna_tpu_torch.io.packing import is_valid_sequence


def iter_fastq_records(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (id, sequence, quality) tuples, reference header heuristics."""
    with open_maybe_gzip(path) as fh:
        it = iter(fh)
        for line in it:
            line = line.rstrip("\n")
            if not line or line[0] != "@":
                continue
            rid = line[1:]
            seq = next(it, "").rstrip("\n")
            next(it, "")  # '+' line, ignored
            qual = next(it, "").rstrip("\n")
            yield rid, seq, qual


def load_fastq_dict(path: str, min_len: int = 0) -> Dict[str, str]:
    """id -> sequence with last-VALID-occurrence-wins duplicate handling
    (ACGT-only, length >= min_len, checked before the insert)."""
    out: Dict[str, str] = {}
    for rid, seq, _ in iter_fastq_records(path):
        if len(seq) < min_len or not is_valid_sequence(seq):
            continue
        out[rid] = seq
    return out
