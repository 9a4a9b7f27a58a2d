"""Index construction, one k or several.

Reference pipeline (build_and_save_index, src/main.cpp:56-92 and
build_kmer_to_transcript_map, src/sketch.cpp:51-74):
  - transcripts shorter than any configured k are stored in the index
    but not sketched (src/main.cpp:66-75),
  - per transcript and k: the FracMinHash sketch (a set),
  - per k, an inverted map: hash -> ascending transcript ids.

Every sketchable transcript is concatenated into one flat code array;
per k, kernel K3 hashes it in chunks (one row each, on the index's
device; its plain version on the CPU) and returns the chunk's kept
(hash, window) pairs alone.  A kept window counts iff it lies inside one
transcript (the reference rolls within a single sequence,
src/sketch.cpp:31-37), which is tested on those pairs only, as the JAX
package's _hash_pos_batch / _resolve_pairs do.  One `torch.unique` of the
packed (hash, tid) pairs then sorts and dedups them, and the CSR arrays
follow.  The result is bit-equal to the JAX package's build_index.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
from sketch_rna_tpu_torch.index.artifact import IndexArtifact, KIndex
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import encode_sequence

log = logging.getLogger(__name__)

# Windows hashed per K3 call: bounds its output when every window is kept.
_CHUNK = 1 << 22
_TID_BITS = 31


def _build_k(flat, owner, end_of, tids, k: int, fraction: float) -> KIndex:
    """The inverted index of one k over the flat codes of the sketchable
    transcripts (owner / end_of: each base's transcript rank and where
    that transcript ends)."""
    device = flat.device
    n_win = flat.numel() - k + 1
    pairs = []
    for p0 in range(0, n_win, _CHUNK):
        p1 = min(p0 + _CHUNK, n_win)
        # Every window of the chunk lies inside the row, so K3's own length
        # test keeps them all; the transcript bounds decide below.
        span = p1 + k - 1 - p0
        row_len = torch.full((1,), span, dtype=torch.int32, device=device)
        h, win, _ = nthash_sketch(flat[p0 : p1 + k - 1][None, :], row_len, k, fraction)
        pos = win[0].long() + p0  # one row: every lane is a kept window
        inside = pos + k <= end_of[pos]
        pairs.append(torch.where(inside, (h[0] << _TID_BITS) | tids[owner[pos]], -1))
    # Sorted distinct (hash, tid) pairs: set semantics per transcript.
    pair = torch.unique(torch.cat(pairs))
    pair = pair[pair >= 0]  # the windows that crossed a transcript end
    h = pair >> _TID_BITS
    uniq, counts = torch.unique_consecutive(h, return_counts=True)
    keys = uniq.cpu().numpy().astype(np.uint32)
    row_ptr = np.zeros(keys.size + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts.cpu().numpy())
    postings = (pair & ((1 << _TID_BITS) - 1)).cpu().numpy().astype(np.int32)
    return KIndex(keys=keys, row_ptr=row_ptr, postings=postings)


def build_index(records: FastaRecords, config: QuantConfig, device="cuda") -> IndexArtifact:
    """The index of `records` at every k of config, built on `device`: the
    card unless the caller asks for the CPU (K3's plain version)."""
    ks = tuple(sorted(config.kmer_lengths))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_index: no CUDA device; pass device='cpu' to build on the CPU")
    seq_codes = [encode_sequence(seq) for seq in records.seqs]
    if any(c is None for c in seq_codes):
        raise ValueError("records hold a non-ACGT sequence (load_fasta drops those)")
    lengths = np.array([c.size for c in seq_codes], dtype=np.int32)
    # Sketchable: at least as long as every k (src/main.cpp:66-75).
    sketchable = np.flatnonzero(lengths >= max(ks))

    empty = KIndex(keys=np.zeros(0, np.uint32), row_ptr=np.zeros(1, np.int32), postings=np.zeros(0, np.int32))
    per_k = {k: empty for k in ks}
    if sketchable.size:
        sk_lens = torch.from_numpy(lengths[sketchable].astype(np.int64)).to(device)
        flat = torch.from_numpy(np.concatenate([seq_codes[i] for i in sketchable])).to(device)
        # Owner (sketchable rank) of every base, and where that owner ends.
        owner = torch.repeat_interleave(torch.arange(sketchable.size, device=device), sk_lens)
        end_of = torch.cumsum(sk_lens, 0)[owner]
        tids = torch.from_numpy(sketchable.astype(np.int64)).to(device)
        per_k = {k: _build_k(flat, owner, end_of, tids, k, config.sketch_fraction) for k in ks}
    for k in ks:
        log.info(
            "index k=%d: %d keys, %d postings over %d sketchable transcripts",
            k, per_k[k].num_keys, per_k[k].postings.size, sketchable.size,
        )
    return IndexArtifact(
        names=list(records.names),
        lengths=lengths,
        kmer_lengths=ks,
        sketch_fraction=config.sketch_fraction,
        per_k=per_k,
    )
