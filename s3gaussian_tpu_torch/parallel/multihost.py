"""Multi-process training (port of ``s3gaussian_tpu/parallel/multihost.py``).

One process per device on ``torch.distributed``: the process group is the
data-parallel mesh, and each rank owns one device, one camera (or one rig)
of the global batch and a full replica of the train state.

  * ``init_multihost`` joins the process group from the JAX package's
    ``S3G_COORDINATOR`` / ``S3G_NUM_PROCESSES`` / ``S3G_PROCESS_ID``
    variables or from torchrun's ``MASTER_ADDR`` / ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK``; with no coordinator anywhere it is a
    no-op returning ``(0, 1)``, so one entry point serves one card and
    many;
  * ``local_batch_slice`` is this rank's ``[start, stop)`` of a global
    batch that every rank pops in the same seeded order;
  * ``is_primary`` / ``sync_hosts``: only rank 0 writes, the others wait
    at a barrier.

The JAX module's ``host_local_camera_batch`` / ``host_local_camera_blocks``
have no counterpart: they stitch per-host camera stacks into one global
array sharded over a device mesh, while here each rank keeps its own
cameras (``local_batch_slice``) and only gradients cross ranks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# a rank that dies fails the others' collectives after this long instead
# of hanging the run
TIMEOUT_S = 600.0


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   backend: Optional[str] = None, device: str = "cuda"
                   ) -> Tuple[int, int]:
    """Join the process group and return ``(rank, world size)``.

    The coordinator is ``coordinator_address``, else ``S3G_COORDINATOR``
    (``host:port``, or a ``tcp://`` / ``file://`` URL), else torchrun's
    ``MASTER_ADDR`` (``env://``); the world size and rank come from the
    arguments, ``S3G_NUM_PROCESSES`` / ``S3G_PROCESS_ID`` or ``WORLD_SIZE``
    / ``RANK``.  A group already up is returned as it is.  The backend is
    ``backend``, else NCCL for a CUDA ``device`` and gloo for the CPU;
    there is no fallback to another backend or device.  A CUDA rank first
    selects card ``LOCAL_RANK`` (default: the rank) modulo the cards it
    sees."""
    if dist.is_initialized():
        return rank_world()
    env = os.environ
    coordinator = coordinator_address or env.get("S3G_COORDINATOR")
    if num_processes is None:
        num_processes = int(env.get("S3G_NUM_PROCESSES")
                            or env.get("WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(env.get("S3G_PROCESS_ID") or env.get("RANK") or 0)
    if coordinator is not None:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    elif env.get("MASTER_ADDR"):
        init_method = "env://"
    elif num_processes > 1:
        raise ValueError(f"{num_processes} processes but no coordinator: "
                         "set S3G_COORDINATOR or MASTER_ADDR")
    else:
        return 0, 1
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return rank_world()


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of a ``global_batch`` whose rows map
    one-to-one onto the ranks' devices.  Every rank pops the batch from
    identically seeded shuffles, so row i means the same camera on every
    rank; each keeps only its own rows."""
    rank, world = rank_world()
    per = global_batch // world
    if per * world != global_batch:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {world} ranks")
    return rank * per, (rank + 1) * per


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and eval output."""
    return rank_world()[0] == 0


def sync_hosts(name: str = "s3g") -> None:
    """Barrier across the ranks (checkpoint and eval boundaries); a no-op
    for one process.  ``name`` labels the call site, as in JAX."""
    del name
    if rank_world()[1] > 1:
        dist.barrier()
