"""torch.profiler integration (the reference's gprof workflow, and the
JAX package's jax.profiler hook, on the GPU).

Set SKETCH_TPU_PROFILE=/some/dir to capture a trace of the quant engines:
maybe_trace(tag) writes a Chrome trace (CPU activities, and CUDA ones on
a card) to /some/dir/<tag>/trace_<pid>.json, one file per process, to
view in chrome://tracing or Perfetto.  Without the variable it does
nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

log = logging.getLogger("sketch_rna_tpu_torch.profiling")

PROFILE_ENV = "SKETCH_TPU_PROFILE"


@contextlib.contextmanager
def maybe_trace(tag: str):
    """Trace the enclosed block if SKETCH_TPU_PROFILE is set."""
    out_dir = os.environ.get(PROFILE_ENV)
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, tag)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log.info("capturing a torch.profiler trace -> %s", path)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, f"trace_{os.getpid()}.json"))
