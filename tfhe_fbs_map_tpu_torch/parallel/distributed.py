"""Multi-process runs of the mesh executor over ``torch.distributed``.

The counterpart of ``tfhe_fbs_map_tpu.parallel.distributed``.  Every
process builds the same keys and the same whole-batch ciphertexts from one
seed and keeps its dp slices; the global mesh lists each process's
positions, ordered process-major as ``jax.devices()`` orders them, and
each tp group lies inside one process.  The hot path has no collectives
between processes: the only ones are on the host, gathering the decoded
outputs and the barriers around a timed run.  So the process group
is gloo, which also runs on the CPU and lets two ranks share one GPU
(NCCL refuses that).

Single-process runs skip initialization and get the local mesh; the
executor code is the same either way.  ``torchrun`` sets the environment
:func:`init_distributed` reads:

    torchrun --nproc-per-node 2 -m tfhe_fbs_map_tpu_torch.runtime prog.lbf \\
        --mesh auto
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["init_distributed", "global_mesh", "local_gpus",
           "gather_outputs", "barrier", "process_index", "shutdown",
           "TIMEOUT"]

# How long a collective (or the rendezvous) waits for the other processes
# before it raises.
TIMEOUT = timedelta(minutes=5)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the process group when running multi-process.

    Arguments default to torch's standard environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``coordinator`` "host:port", ``WORLD_SIZE``,
    ``RANK``), which ``torchrun`` sets.  Returns True once this process is
    in a group of two or more (gloo, :data:`TIMEOUT`), False for a single
    process, which initializes nothing."""
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("RANK") or -1)
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if not coordinator or not 0 <= process_id < num_processes:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"address (MASTER_ADDR, MASTER_PORT) and a rank "
                         f"in [0, {num_processes}) (RANK), got "
                         f"{coordinator!r} and {process_id}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group (nothing in a single process).  A process
    that exits with its gloo group alive can abort in the group's
    destructor ("terminate called without an active exception")."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every process (nothing in a single process)."""
    if dist.is_initialized():
        dist.barrier()


def local_gpus() -> list[torch.device]:
    """This process's GPUs: every visible one, or under ``torchrun``
    (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) its share of the host's, GPU i
    to local rank i mod ``LOCAL_WORLD_SIZE`` (with more local processes
    than GPUs, processes share one).  Raises RuntimeError without a GPU."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible")
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    rank = int(os.environ.get("LOCAL_RANK") or 0)
    if local <= 1:
        ids = range(count)
    elif local >= count:
        ids = [rank % count]
    else:
        ids = [i for i in range(count) if i % local == rank]
    return [torch.device("cuda", i) for i in ids]


def global_mesh(tp: int = 1, devices=None) -> Mesh:
    """The (dp, tp) mesh over every process's positions, process-major,
    tp innermost.

    ``devices``: this process's positions (default: :func:`local_gpus`);
    every process must have as many, and ``tp`` must divide that number,
    JAX's rule: a tp group may not span processes, since its partial
    products meet every CMux step (gloo carries only host objects).
    Outside a process group it is :func:`.mesh.make_mesh` of them."""
    positions = list(local_gpus() if devices is None else devices)
    if tp < 1 or len(positions) % tp:
        raise ValueError(f"tp={tp} must divide the {len(positions)} local "
                         f"positions (a tp group may not span processes)")
    local = make_mesh(positions, tp=tp)
    if not dist.is_initialized():
        return local
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local.devices))
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold {counts} positions: every "
                         f"process must hold as many")
    groups = counts[0] // tp
    return Mesh(local.devices, groups * len(counts),
                dist.get_rank() * groups, tp)


def gather_outputs(outputs: dict[str, np.ndarray]
                   ) -> dict[str, np.ndarray]:
    """Every process's decoded outputs (each its slice of the batch, in
    mesh order), concatenated along the batch in process order: the whole
    batch, on every process."""
    if not dist.is_initialized():
        return outputs
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, outputs)
    return {k: np.concatenate([p[k] for p in parts]) for k in outputs}
