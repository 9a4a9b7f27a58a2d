"""The readings that a cell's limits (limits/<workload>.json) are set from,
in one process on the card:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... [--control-seeds 11,12,13]

For each seed it draws the cell's pool of samples as a run does, and for
the pool samples a run with that seed would check (check_samples of
them, chosen from the seed), it quantifies each through the timed path
(pipeline.quantify at the configuration's settings) and compares it with
the reference: the lower readings.  For the control seeds it does the
same with the control, the program's own float32 EM path
(em_dtype="float32", the precision below the configuration's float64):
the upper readings.  One JSON line a seed and kind, then a summary line
of each number's largest program reading and smallest control reading.
The benchmark's runs never run this.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(root: Path, workload: str, seeds, control_seeds, device=None):
    """Yield one dict a seed and kind ("program" or "control"): the worst
    readings over the seed's checked pool samples, as a run's check reads
    them (harness.checked_samples, harness.reference_check)."""
    import torch

    from perfbench import cache, gen, harness
    from sketch_rna_tpu_torch.index.artifact import to_device
    from sketch_rna_tpu_torch.pipeline import quantify

    bench = harness.load_bench(root)
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = harness.load_named(root, "configs", cell["config"])
    mix = harness.load_mix(root, cell["traffic"])
    dev = torch.device(device or "cuda")
    config = harness.quant_config(cfg)
    kinds = {"program": config, "control": dataclasses.replace(config, em_dtype="float32")}
    flat, lengths, _ = cache.transcriptome(root, cfg)
    artifact, _ = cache.program_index(root, cfg, flat, lengths, dev)
    index = to_device(artifact, dev)
    ref_index = harness.reference_index(cfg, flat, lengths, dev)
    flat_d = torch.from_numpy(flat).to(dev)
    for seed in sorted(set(seeds) | set(control_seeds)):
        pool = gen.draw_pool(seed, flat_d, torch.from_numpy(lengths), mix)
        chosen = harness.checked_samples(seed, range(len(pool)), mix["check_samples"])
        for kind in [k for k, wanted in (("program", seeds), ("control", control_seeds)) if seed in wanted]:
            t0 = time.perf_counter()
            kept = {p: [harness.answer(quantify(index, pool[p], kinds[kind]))] for p in chosen}
            worst = harness.reference_check(ref_index, cfg, lengths, pool, kept, dev)
            yield {"workload": workload, "seed": seed, "kind": kind, "samples": chosen,
                   "seconds": time.perf_counter() - t0, **worst}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of the control's readings")
    args = ap.parse_args(argv)
    import torch

    from perfbench.check import NUMBERS

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for row in readings(ROOT, args.workload, seeds, control_seeds):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}
    for kind, pick in (("program", max), ("control", min)):
        mine = [r for r in rows if r["kind"] == kind]
        if mine:
            summary[kind] = {name: pick(r[name] for r in mine) for name in NUMBERS}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
