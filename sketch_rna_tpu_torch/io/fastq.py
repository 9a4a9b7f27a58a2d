"""FASTQ parsing with the reference's exact single-pass record semantics.

Mirrors process_fastq_single_pass (reference src/main.cpp:107-151):
  - any line starting '@' is a record header; the next three lines are
    sequence, '+' separator (ignored) and quality,
  - lines between records that don't start '@' are skipped,
  - the read ID is the FULL header minus '@' (src/main.cpp:122),
  - only records that pass validation are inserted into the id map, so
    the LAST VALID occurrence of an ID wins (src/main.cpp:132-150).

The byte-range readers give every rank process of a multi-process run
its own part of an uncompressed file: the ranges cover the file, each
record belongs to the range that holds its header's first byte, and the
ranges' records together are exactly those of a sequential parse.
"""

from __future__ import annotations

import os
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


def byte_range_for_process(path: str, process_index: int, process_count: int) -> Tuple[int, int]:
    """(start, end) byte bounds of part process_index when an uncompressed
    FASTQ is split evenly by size into process_count parts.  Records are
    aligned in iter_fastq_records_range."""
    size = os.path.getsize(path)
    start = (size * process_index) // process_count
    end = (size * (process_index + 1)) // process_count
    return start, end


def _align_to_record(fh, start: int) -> None:
    """Position fh at the first record header at or after byte `start`.

    A header is a line starting '@' whose line-after-next starts '+' (the
    separator): this tells it from a quality line that begins with '@',
    which the reference's sequential pass never tests as a header
    (src/main.cpp:121-133 consumes the quality line inside its record)."""
    fh.seek(start)
    if start > 0:
        # Step back one byte, so that a header starting exactly at `start`
        # is kept: the line skipped is then the rest of the line before it.
        fh.seek(start - 1)
        fh.readline()
    while True:
        pos = fh.tell()
        line = fh.readline()
        if not line:
            return
        if line[:1] == b"@":
            probe = fh.tell()
            fh.readline()  # sequence
            plus = fh.readline()
            fh.seek(probe)
            if plus[:1] == b"+":
                fh.seek(pos)
                return


def iter_fastq_records_range(path: str, start: int, end: int) -> Iterator[Tuple[str, str, str]]:
    """Yield the records whose header's byte offset lies in [start, end).

    Processes that iterate disjoint covering ranges yield exactly the
    records of a full sequential parse, each once; a record that
    straddles `end` belongs to the range that holds its header.
    Uncompressed files only (byte offsets)."""
    with open(path, "rb") as fh:
        _align_to_record(fh, start)
        while True:
            pos = fh.tell()
            if pos >= end:
                return
            line = fh.readline()
            if not line:
                return
            line = line.rstrip(b"\n")
            if not line or line[:1] != b"@":
                continue
            rid = line[1:].decode()
            seq = fh.readline().rstrip(b"\n").decode()
            fh.readline()  # '+' separator
            qual = fh.readline().rstrip(b"\n").decode()
            yield rid, seq, qual


def load_fastq_dict_range(path: str, start: int, end: int, min_len: int = 0) -> Dict[str, str]:
    """load_fastq_dict over a byte range: the same validation-first
    duplicate rule, applied within the range (a duplicate ID whose two
    records fall into different ranges is kept twice; real read IDs are
    unique)."""
    out: Dict[str, str] = {}
    for rid, seq, _ in iter_fastq_records_range(path, start, end):
        if len(seq) < min_len or not is_valid_sequence(seq):
            continue
        out[rid] = seq
    return out


def load_fastq_with_quality(path: str, min_len: int = 0) -> Dict[str, Tuple[str, str]]:
    """id -> (sequence, quality), with load_fastq_dict's duplicate and
    validation rules: the reference's whole Read record
    (include/data_io.h:38-43), for callers that want the quality strings
    no quant math reads."""
    out: Dict[str, Tuple[str, str]] = {}
    for rid, seq, qual in iter_fastq_records(path):
        if len(seq) < min_len or not is_valid_sequence(seq):
            continue
        out[rid] = (seq, qual)
    return out
