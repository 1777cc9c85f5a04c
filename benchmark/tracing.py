"""Reading a torch.profiler trace (its Chrome-trace events) into what the
per-layer metrics read.

Only complete events (``"ph": "X"``) count. Device work is every event of
category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; the traced window is
the harness's ``record_function("window")`` span. Busy time is the union
of the device intervals inside the window, so work on two streams at once
counts once. A kernel belongs to the layer whose name patterns
(``benchmark/layers/<layer>.json``) first match its name, files taken in
name order; a kernel that none matches is reported, not guessed.

A launch is a host call of the CUDA runtime or driver that starts a
kernel, matched to its kernel by the trace's correlation id. A launch in
the window whose kernel the trace lacks marks the trace incomplete: the
profiler has been seen to drop device events, and no metric is read from
such a trace.
"""

from __future__ import annotations

import bisect
import json
import pathlib

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
WINDOW = "window"
SPANS = ("next_frame", "stream.next", "__call__", "host_result")
BREAKDOWN_ENTRIES = 10


def load_layers(directory) -> dict:
    """``{layer file stem: {"layer": name, "patterns": [...]}}`` of every
    ``*.json`` in ``directory``."""
    out = {}
    for path in sorted(pathlib.Path(directory).glob("*.json")):
        spec = json.loads(path.read_text())
        if not spec.get("patterns") or not spec.get("layer"):
            raise ValueError(f"{path}: a layer file needs 'layer' and "
                             "'patterns'")
        out[path.stem] = spec
    return out


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window. Times in the trace are
    microseconds; the methods return seconds."""

    def __init__(self, events: list, layers: dict):
        self.layers = layers
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in x if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"the trace holds {len(wins)} window spans")
        self.t0 = float(wins[0]["ts"])
        self.t1 = self.t0 + float(wins[0]["dur"])
        inside = lambda e: self.t0 <= float(e["ts"]) <= self.t1
        self.device = [e for e in x if e.get("cat") in DEVICE_CATS
                       and inside(e)]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.copies = [e for e in self.device if e["cat"] == "gpu_memcpy"]
        self.launches = self._launches([e for e in x if inside(e)])
        self.spans = [e for e in x if e.get("cat") == "user_annotation"
                      and e.get("name") in SPANS and inside(e)]
        self._layer_of = {}

    @staticmethod
    def _corr(e):
        return (e.get("args") or {}).get("correlation")

    def _launches(self, events):
        """Correlation ids of the window's kernel launches. A driver call
        made inside a runtime launch on the same thread is the same
        launch and counts once."""
        api = [e for e in events if e.get("cat") in HOST_API_CATS
               and e.get("name") in LAUNCH_CALLS]
        runtime: dict = {}
        for e in api:
            if e["cat"] == "cuda_runtime":
                runtime.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        starts = {}
        for tid, ivs in runtime.items():
            ivs.sort()
            starts[tid] = [a for a, _ in ivs]
        ids = []
        for e in api:
            if e["cat"] == "cuda_driver" and e.get("tid") in runtime:
                ivs = runtime[e.get("tid")]
                i = bisect.bisect_right(starts[e.get("tid")],
                                        float(e["ts"])) - 1
                if i >= 0 and (float(e["ts"]) + float(e["dur"])
                               <= ivs[i][1]):
                    continue
            ids.append(self._corr(e))
        return ids

    # -- completeness --------------------------------------------------
    def lost_launches(self) -> int:
        """Launches in the window whose kernel the trace does not hold."""
        have = {self._corr(k) for k in self.kernels}
        return sum(1 for c in self.launches if c not in have)

    def complete(self) -> bool:
        return bool(self.kernels) and self.lost_launches() == 0

    # -- time ----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self, events):
        return [(max(float(e["ts"]), self.t0),
                 min(float(e["ts"]) + float(e["dur"]), self.t1))
                for e in events]

    def busy_s(self) -> float:
        return sum(b - a for a, b in _merged(self._clipped(self.device))) \
            / 1e6

    def layer_of(self, name: str):
        if name not in self._layer_of:
            self._layer_of[name] = next(
                (lid for lid, spec in self.layers.items()
                 if any(p in name for p in spec["patterns"])), None)
        return self._layer_of[name]

    def kernel_s(self, layer=None, exclude=()) -> float:
        """Device seconds of the window's kernels: of ``layer`` (a layer
        file's stem), or of every kernel not in ``exclude``'s layers."""
        total = 0.0
        for k in self.kernels:
            lid = self.layer_of(k["name"])
            if (lid == layer) if layer is not None else lid not in exclude:
                total += float(k["dur"])
        return total / 1e6

    def copy_s(self, kinds=("HtoD", "DtoH")) -> float:
        return sum(float(e["dur"]) for e in self.copies
                   if any(k in e["name"] for k in kinds)) / 1e6

    def unassigned(self) -> list:
        return sorted({k["name"] for k in self.kernels
                       if self.layer_of(k["name"]) is None})

    def kernel_count(self, pattern: str) -> int:
        """Kernels launched in the window whose name holds ``pattern``."""
        launched = set(self.launches)
        return sum(1 for k in self.kernels if pattern in k["name"]
                   and self._corr(k) in launched)

    # -- breakdown -----------------------------------------------------
    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost harness span the host was in at each
        gap's middle (``outside spans`` where it was in none)."""
        by_op: dict = {}
        for e in self.device:
            by_op[e["name"]] = by_op.get(e["name"], 0.0) + float(e["dur"])
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])
        gaps: dict = {}
        busy = _merged(self._clipped(self.device))
        edges = [self.t0] + [t for iv in busy for t in iv] + [self.t1]
        spans = sorted(((float(s["ts"]), float(s["ts"]) + float(s["dur"]),
                         s["name"]) for s in self.spans))
        starts = [s0 for s0, _, _ in spans]
        reach, top = [], float("-inf")          # latest end so far
        for _, s1, _ in spans:
            top = max(top, s1)
            reach.append(top)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "outside spans"
            # spans of one thread nest: the innermost one holding ``mid``
            # is the latest-starting one that has not ended by then
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and reach[i] >= mid:
                if spans[i][1] >= mid:
                    label = spans[i][2]
                    break
                i -= 1
            gaps[label] = gaps.get(label, 0.0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:120], v / 1e6]
                               for n, v in ops[:BREAKDOWN_ENTRIES]],
                "idle_gaps": [[n, v / 1e6]
                              for n, v in idle[:BREAKDOWN_ENTRIES]]}


def read(path, layers: dict) -> Trace:
    data = json.loads(pathlib.Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events, layers)
