"""The measured window: a closed loop over the system's entry point.

``stream``: the system's ``stream()`` pulls frames from a generator, which
hands over the pool's frames in turn until the window's time is up; every
frame it yields is a host array. A frame's lag runs from its handover to
its yield. ``call``: one caller sends a frame to ``__call__`` and waits
for the host array before it sends the next. The window runs from the
first handover to the last result, so it holds all the work and all the
time, the stream's drain included.

A sample of the results, drawn from the seed over the whole window
(reservoir sampling), is kept for the correctness check; each result's
shape and type are checked as it arrives. With ``span`` (the
traced run) the loop marks its own calls into the system with
``record_function``: ``next_frame``, ``stream.next``, ``__call__``,
``host_result``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import numpy as np


@dataclasses.dataclass
class Sample:
    """Up to ``size`` results of the window, drawn uniformly over all of
    them from ``seed``: ``frames[i]`` is the result of pool frame
    ``pool_ids[i]``. A result is kept as the host array the system
    returned, not copied, so keeping it costs the window no copy; set-up
    serves as many frames as are kept, so that the program's pinned host
    blocks are already allocated."""

    size: int
    seed: int
    seen: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.frames: list = [None] * self.size
        self.pool_ids = [-1] * self.size

    def offer(self, pool_id: int, out: np.ndarray) -> None:
        k = self.seen
        self.seen += 1
        j = k if k < self.size else self._rng.randrange(k + 1)
        if j < self.size:
            self.frames[j] = out
            self.pool_ids[j] = pool_id

    def taken(self):
        n = min(self.seen, self.size)
        return self.frames[:n], self.pool_ids[:n]


@dataclasses.dataclass
class Window:
    """What one window measured, on the host's clock."""

    seconds: float
    attempted: int
    completed: int
    failed: int
    #: per frame: lag (stream) or call time (call), seconds
    times: list


def _spans(on: bool):
    if not on:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def run_stream(system, pool, seconds, out_shape, sample, *, microbatch,
               span=False) -> Window:
    mark, clock = _spans(span), time.perf_counter
    n_pool = len(pool)
    handed: list[float] = []
    deadline = None

    def frames():
        k = 0
        while clock() < deadline:
            with mark("next_frame"):
                handed.append(clock())
                f = pool[k % n_pool]
            k += 1
            yield f

    lags, failed, k = [], 0, 0
    start = clock()
    deadline = start + seconds
    it = system.stream(frames(), microbatch=microbatch)
    while True:
        with mark("stream.next"):
            out = next(it, None)
        if out is None:
            break
        lags.append(clock() - handed[k])
        with mark("host_result"):
            if out.shape != out_shape or out.dtype != np.uint8:
                failed += 1
            else:
                sample.offer(k % n_pool, out)
        k += 1
    end = clock()
    missing = len(handed) - k
    return Window(end - start, len(handed), k - failed, failed + missing,
                  lags)


def run_call(system, pool, seconds, out_shape, sample, *,
             span=False) -> Window:
    mark, clock = _spans(span), time.perf_counter
    n_pool = len(pool)
    times, failed, k = [], 0, 0
    start = clock()
    deadline = start + seconds
    while True:
        t0 = clock()
        if t0 >= deadline:
            break
        with mark("__call__"):
            out = system(pool[k % n_pool])
        times.append(clock() - t0)
        with mark("host_result"):
            if out.shape != out_shape or out.dtype != np.uint8:
                failed += 1
            else:
                sample.offer(k % n_pool, out)
        k += 1
    end = clock()
    return Window(end - start, k, k - failed, failed, times)


def run(mix, system, pool, seconds, out_shape, sample, span=False):
    if mix["entry"] == "stream":
        return run_stream(system, pool, seconds, out_shape, sample,
                          microbatch=mix.get("microbatch", "auto"),
                          span=span)
    return run_call(system, pool, seconds, out_shape, sample, span=span)
