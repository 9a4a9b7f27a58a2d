"""Process-group initialisation: one rank process per GPU.

The counterpart of sketch_rna_tpu/dist/init.py over torch.distributed.
Every rank process calls init_distributed() once before it builds a mesh
(dist/mesh.py): with --coordinator HOST:PORT, --num-processes and
--process-id from the CLI, or with RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT in the environment, so torchrun works.

Unlike the JAX function, a failed initialisation raises: a rank that
carried on alone would quantify the whole file by itself and write a
plausible CSV (the silent fallback tests/test_multiprocess.py guards
against).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

log = logging.getLogger(__name__)

# Seconds a rank waits for the others at the rendezvous, and for any later
# collective on gloo, before it raises (a deployment setting).
TIMEOUT_ENV = "SKETCH_TPU_DIST_TIMEOUT"
DEFAULT_TIMEOUT_S = 600.0


def _local(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's compute device: the CPU when asked, else
    cuda:(local rank % device count) — ranks share a card when there are
    fewer cards than ranks — made the process's current CUDA device,
    which is where the hand-written kernels launch.  Raises without a
    CUDA device."""
    import torch.distributed as dist

    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; ask for the CPU to run every kernel's plain version")
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    device = torch.device("cuda", _local("LOCAL_RANK", rank) % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def pick_backend(device_type: str, world_size: int) -> str:
    """nccl when every rank of this host has a GPU of its own (NCCL
    refuses two ranks on one device), else gloo."""
    if device_type == "cuda" and torch.cuda.is_available():
        if _local("LOCAL_WORLD_SIZE", world_size) <= torch.cuda.device_count():
            return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group when running multi-process.

    Returns False (and does nothing) when single-process: no coordinator
    given and no WORLD_SIZE > 1 in the environment (a process count or a
    rank without either raises: it must not run alone).  Otherwise the
    arguments win over the environment, the rendezvous waits at most
    timeout_s (default: SKETCH_TPU_DIST_TIMEOUT or 600 s), and any
    failure raises.  backend: "nccl" or "gloo"; None picks (pick_backend).
    """
    import torch.distributed as dist

    env_world = _local("WORLD_SIZE", 1)
    if coordinator_address is None and env_world <= 1:
        if (num_processes or 1) > 1 or process_id:
            raise ValueError("a process count or rank needs a coordinator address (HOST:PORT) to meet the others at")
        return False
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    world_size = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else _local("RANK", -1)
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"process id {rank} is not a rank of {world_size} processes")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if init_method.split("//")[1].rsplit(":", 1)[0] in ("localhost", "127.0.0.1"):
        # Every rank runs on this host: use the loopback interface, so a
        # host whose name does not resolve (a container without a
        # network) still starts.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if timeout_s is None:
        timeout_s = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    backend = backend or pick_backend(device_type, world_size)
    if backend == "nccl":
        torch.cuda.set_device(_local("LOCAL_RANK", rank) % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    log.info("torch.distributed initialized: rank %d of %d, backend %s", rank, world_size, backend)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
