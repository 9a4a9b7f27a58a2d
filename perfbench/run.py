"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the result (one JSON
object); the numbers that decide `correct` are the last lines of standard
error.  Exits nonzero, printing no result, without the devices, without
the port's package beside this folder, or when JAX or the JAX package was
loaded.  See README.md.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches of the program and its libraries, at fixed paths
# inside the checkout, so that only a cell's first run there builds.
CACHE = ROOT / "perfbench" / ".cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    if not (ROOT / "sketch_rna_tpu_torch").is_dir():
        print(f"perfbench: no program package sketch_rna_tpu_torch beside perfbench/ in {ROOT}", file=sys.stderr)
        sys.exit(1)
    from perfbench.harness import main

    sys.exit(main(root=ROOT, t_process=T_PROCESS))
