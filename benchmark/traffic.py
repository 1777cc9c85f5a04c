"""The one generator of traffic: a pool of host frames from a mix's
parameters and the run's seed.

A mix (``benchmark/traffic/<name>.json``) gives the frame shape
(``frame``: rows, columns, channels), the number of distinct frames in the
pool (``pool``), the entry point that serves them (``entry``: ``stream`` or
``call``), its ``microbatch`` for ``stream``, the frames served before the
window to warm every shape (``warmup_frames``), the size of the sample
that decides ``correct`` (``sample``) and the length of the traced window
(``trace_seconds``). Every seed gives the same sizes; the seed changes only
the content. Frames are uint8 numpy arrays in host memory, as a caller
hands them in: photo-like content (smooth shading, hard edges, texture
noise) with an opaque alpha.
"""

from __future__ import annotations

import numpy as np

ENTRIES = ("stream", "call")
KEYS = ("frame", "pool", "entry", "warmup_frames", "sample",
        "trace_seconds")


def check_mix(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}")
    h, w, c = mix["frame"]
    if min(h, w) < 1 or not 1 <= c <= 4 or mix["pool"] < 1:
        raise ValueError(f"bad frame {mix['frame']} or pool {mix['pool']}")
    if mix["sample"] < 1 or mix["warmup_frames"] < 1:
        raise ValueError("sample and warmup_frames must be at least 1")
    return mix


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of one seed (any integer)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def frame(rng: np.random.Generator, h: int, w: int, c: int) -> np.ndarray:
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    out = np.full((h, w, c), 255, np.uint8)
    for ch in range(min(c, 3)):
        fx, fy = rng.uniform(0.002, 0.05, 2)
        px, py = rng.uniform(0.0, 2 * np.pi, 2)
        cx, cy = rng.integers(8, 97, 2)
        v = 110.0 * np.sin(fx * x + px) * np.cos(fy * y + py)
        v += 40.0 * (((x // cx) + (y // cy)) % 2) + 108.0
        v += rng.standard_normal((h, w), dtype=np.float32) * 8.0
        np.clip(v, 0.0, 255.0, out=v)
        out[..., ch] = v
    return out


def pool(mix: dict, seed: int) -> list[np.ndarray]:
    """``mix["pool"]`` distinct frames of ``mix["frame"]``'s shape."""
    h, w, c = mix["frame"]
    rng = rng_for(seed, 0)
    return [frame(rng, h, w, c) for _ in range(mix["pool"])]
