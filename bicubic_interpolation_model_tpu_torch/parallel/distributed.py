"""Multi-host initialization (counterpart of
``bicubic_interpolation_model_tpu/parallel/distributed.py``).

One call at program start on every host::

    from bicubic_interpolation_model_tpu_torch.parallel import distributed
    distributed.initialize()          # no-op on a single host

``torch.distributed`` (gloo on the CPU, NCCL where CUDA is present) with
the rank and world size in place of JAX's process index and count. The band
and batch paths of :mod:`.spatial` and :mod:`.batch` do not use it: they
run one process over the devices of a :class:`~.mesh.Mesh`.
:func:`shard_host_batch` splits a global batch across hosts by rank (each
host materializes only its slice).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group when a multi-host run is asked for: a
    ``coordinator`` ("host:port", else ``BIM_TPU_COORDINATOR``) or a
    ``num_processes``. Returns True if distributed mode is active; a single
    host takes it only by explicit opt-in. Without a coordinator the
    ``MASTER_ADDR``/``MASTER_PORT`` environment is read."""
    coordinator = coordinator or os.environ.get("BIM_TPU_COORDINATOR")
    if coordinator is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    return True


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(global_batch: int) -> slice:
    """This host's slice of a globally-indexed batch."""
    i, n = _rank_and_size()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_host_batch(make_global, global_batch: int):
    """Materialize only this host's shard of a batch: ``make_global`` is
    called with (start, count) and should return [count, ...] arrays."""
    s = host_slice(global_batch)
    return make_global(s.start, s.stop - s.start)
