"""EM-state checkpoint / resume, in the JAX package's `.npz` layout.

The EM state is (pi, iterations_done) plus a fingerprint of the run, so
a resumed run continues the loop from the saved pi with the remaining
iteration budget.  The file holds the same keys and FORMAT_VERSION as
sketch_rna_tpu/em/checkpoint.py, so a checkpoint written by either
package resumes in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class EMState:
    pi: np.ndarray  # [T]
    iterations_done: int
    num_reads: int
    fingerprint: str  # guards against resuming with a different setup


def save_em_state(path: str, state: EMState) -> None:
    """Write the state (np.savez_compressed adds ".npz" to a path
    without it, as in the JAX package)."""
    np.savez_compressed(
        path,
        format_version=np.int32(FORMAT_VERSION),
        pi=state.pi,
        iterations_done=np.int32(state.iterations_done),
        num_reads=np.int64(state.num_reads),
        fingerprint=np.str_(state.fingerprint),
    )


def load_em_state(path: str) -> EMState:
    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError("unsupported EM checkpoint version")
        return EMState(
            pi=z["pi"],
            iterations_done=int(z["iterations_done"]),
            num_reads=int(z["num_reads"]),
            fingerprint=str(z["fingerprint"]),
        )


def fingerprint_of(num_transcripts: int, num_reads: int, config) -> str:
    return (
        f"T={num_transcripts};R={num_reads};k={tuple(config.kmer_lengths)};"
        f"sf={config.sketch_fraction};cf={config.chain_fraction};"
        f"pc={config.pseudocount};conv={config.em_convergence}"
    )


def check_resumable(state: EMState, expected_fingerprint: str) -> None:
    if state.fingerprint != expected_fingerprint:
        raise ValueError(
            "EM checkpoint fingerprint mismatch: "
            f"saved '{state.fingerprint}' vs expected '{expected_fingerprint}'"
        )
