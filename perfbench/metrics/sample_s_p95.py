"""The 95th percentile of the per-sample host seconds over the window's
untraced samples (numpy's linear interpolation): the tail of a closed
loop, which host stalls set."""

import numpy as np


def read(run):
    seconds = [s.seconds for s in run.untraced()]
    return float(np.percentile(seconds, 95)) if seconds else None
