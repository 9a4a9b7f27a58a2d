"""One rank process of the port's multi-rank CPU tests (no test itself).

    python tests/torch_dist_worker.py RANK WORLD PORT WORKDIR

Joins a gloo process group of WORLD ranks at localhost:PORT on the CPU
and runs every job of WORKDIR/plan.json, in order, writing each job's
result to WORKDIR/<job>.rank<RANK>.npz.  A job names an index file
(.npz), a reads file (.npz of codes and lengths), QuantConfig knobs, a
mesh (dp, ip) and a mode:

  quant   pipeline.quantify_sharded on the whole read set (each rank
          takes its data shard's rows);
  slice   the same through local_slice=True: the rank packs only the
          rows of its data shard, as a multi-process parse would;
  auto    quantify_sharded with mesh=None (mesh_factor picks the split);
  step    dist.quant_sharded.quant_step_sharded, the whole-batch form;
  tables  the candidate tables of the rank's data shard through
          match_batch_sharded, for comparison with the unsharded merged
          grouping.

Imports torch and the port only: neither JAX nor pytest.
"""

import functools
import json
import os
import socket
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sketch_rna_tpu_torch.config import QuantConfig  # noqa: E402
from sketch_rna_tpu_torch.dist.init import init_distributed, shutdown  # noqa: E402
from sketch_rna_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from sketch_rna_tpu_torch.dist.quant_sharded import quant_step_sharded  # noqa: E402
from sketch_rna_tpu_torch.dist.quant_stream import match_batch_sharded  # noqa: E402
from sketch_rna_tpu_torch.index.artifact import load_index  # noqa: E402
from sketch_rna_tpu_torch.index.shard import device_index_bytes, shard_to_device  # noqa: E402
from sketch_rna_tpu_torch.io.packing import PackedReads  # noqa: E402
from sketch_rna_tpu_torch.pipeline import match_rows, quantify_sharded  # noqa: E402


def free_port() -> int:
    """A TCP port that was free a moment ago, for a test's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def shard_rows(n: int, d: int, dp: int):
    return (n * d) // dp, (n * (d + 1)) // dp


def run_job(job, rank: int):
    artifact = load_index(job["index"])
    with np.load(job["reads"]) as z:
        codes, lengths = z["codes"], z["lengths"]
    knobs = dict(job["config"])
    knobs["kmer_lengths"] = tuple(knobs["kmer_lengths"])
    config = QuantConfig(**knobs)
    mode = job["mode"]
    if mode == "auto":
        res = quantify_sharded(artifact, PackedReads(codes, lengths, []), config, device="cpu")
        return _result_arrays(res)
    mesh = make_mesh(*job["mesh"], device="cpu")
    r0, r1 = shard_rows(len(lengths), mesh.d, mesh.dp)
    if mode == "quant":
        res = quantify_sharded(artifact, PackedReads(codes, lengths, []), config, mesh)
        out = _result_arrays(res)
        out["index_bytes"] = device_index_bytes(shard_to_device(artifact, mesh.ip, mesh.i, "cpu"))
        return out
    if mode == "slice":
        mine = PackedReads(codes[r0:r1], lengths[r0:r1], [])
        return _result_arrays(quantify_sharded(artifact, mine, config, mesh, local_slice=True))
    shard = shard_to_device(artifact, mesh.ip, mesh.i, "cpu")
    if mode == "step":
        pi, weighted, has, iters, stats = quant_step_sharded(
            torch.from_numpy(codes[r0:r1]), torch.from_numpy(lengths[r0:r1]), shard, len(lengths), config, mesh)
        return dict(pi=pi.numpy(), weighted=weighted.numpy(), has_entry=has.numpy(), iterations=iters,
                    stats=json.dumps(stats))
    if mode == "tables":
        step = functools.partial(match_batch_sharded, index_group=mesh.index_group)
        tid, score, _, stats = match_rows(shard, torch.from_numpy(codes[r0:r1]), lengths[r0:r1], config, step=step)
        return dict(tid=tid.numpy(), score=score.numpy(), rows=np.array([r0, r1]),
                    stats=json.dumps({k: int(v) for k, v in stats.items()}))
    raise ValueError(f"unknown mode {mode}")


def _result_arrays(res):
    return dict(pi=res.pi, weighted=res.weighted_counts, has_entry=res.has_entry, iterations=res.em_iterations,
                num_reads=res.num_reads, num_mapped=res.num_mapped, stats=json.dumps(res.stats))


def main() -> int:
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank, device_type="cpu", timeout_s=120)
    try:
        with open(os.path.join(workdir, "plan.json")) as fh:
            plan = json.load(fh)
        for job in plan:
            np.savez(os.path.join(workdir, f"{job['name']}.rank{rank}.npz"), **run_job(job, rank))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
