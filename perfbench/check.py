"""The comparison that decides a run's `correct`: what the timed path
produced for a sample (pipeline.quantify's QuantResult) against the plain
reference's quant of the same reads (reference/quant.py).

The numbers compared, each with a limit of its own from
limits/<workload>.json:

  pi_rel_err       max over transcripts of |pi - ref| / ref (ref > 0:
                   every pi holds the pseudocount);
  counts_err       max over transcripts of |NumReads - ref| / max(ref, 1):
                   relative for a transcript with a read or more, absolute
                   below;
  has_entry_diff   transcripts whose CSV row is present on one side only;
  num_mapped_diff  |reads with a candidate - ref|.

A sample's readings are the worst over the window results compared with
it; a run's are the worst over its samples.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

NUMBERS = ("pi_rel_err", "counts_err", "has_entry_diff", "num_mapped_diff")


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The readings of one program result (pi, weighted_counts, has_entry,
    num_mapped) against the reference's."""
    pi, rpi = np.asarray(prog["pi"], np.float64), np.asarray(ref["pi"], np.float64)
    w, rw = np.asarray(prog["weighted_counts"], np.float64), np.asarray(ref["weighted_counts"], np.float64)
    if pi.shape != rpi.shape or w.shape != rw.shape:
        return {"pi_rel_err": float("inf"), "counts_err": float("inf"), "has_entry_diff": float(rpi.size),
                "num_mapped_diff": float(abs(int(prog["num_mapped"]) - int(ref["num_mapped"])))}
    return {
        "pi_rel_err": float(np.max(np.abs(pi - rpi) / rpi)) if rpi.size else 0.0,
        "counts_err": float(np.max(np.abs(w - rw) / np.maximum(rw, 1.0))) if rw.size else 0.0,
        "has_entry_diff": float(np.count_nonzero(np.asarray(prog["has_entry"]) != np.asarray(ref["has_entry"]))),
        "num_mapped_diff": float(abs(int(prog["num_mapped"]) - int(ref["num_mapped"]))),
    }


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading (nan counts as the worst)."""
    out = {name: 0.0 for name in NUMBERS}
    for r in readings:
        for name in NUMBERS:
            v = r[name]
            out[name] = float("inf") if v != v else max(out[name], v)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True iff every number is at most its limit."""
    return all(readings[name] <= limits[name] for name in NUMBERS)


def lines(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for the result line and standard error."""
    return {name: {"value": readings[name], "limit": limits[name]} for name in NUMBERS}
