"""The port's multi-host initialization (bicubic_interpolation_model_tpu_
torch/parallel/distributed.py) in two processes on this host, joined by
``torch.distributed`` with the gloo backend over a localhost TCP store:
``initialize``, ``host_slice``, ``shard_host_batch`` and one
``all_reduce`` across the two ranks. Imports nothing of JAX."""

import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

from bicubic_interpolation_model_tpu_torch.parallel import distributed


def _worker(rank, port):
    import torch.distributed as dist
    assert distributed.initialize(f"localhost:{port}", num_processes=2,
                                  process_id=rank)
    try:
        assert dist.get_world_size() == 2 and dist.get_rank() == rank
        assert distributed.initialize(f"localhost:{port}", 2, rank)
        s = distributed.host_slice(8)
        assert (s.start, s.stop) == (rank * 4, (rank + 1) * 4)
        got = distributed.shard_host_batch(
            lambda start, count: torch.arange(start, start + count), 8)
        assert torch.equal(got, torch.arange(rank * 4, rank * 4 + 4))
        total = got.sum().reshape(1).double()
        dist.all_reduce(total)
        assert float(total) == float(sum(range(8)))
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.spawn(_worker, args=(port,), nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two ranks did not finish within 120 s")
    assert all(p.exitcode == 0 for p in ctx.processes)


def test_single_host_without_opt_in(monkeypatch):
    monkeypatch.delenv("BIM_TPU_COORDINATOR", raising=False)
    assert distributed.initialize() is False
    assert distributed.host_slice(6) == slice(0, 6)
    assert distributed.shard_host_batch(lambda a, n: (a, n), 6) == (0, 6)
