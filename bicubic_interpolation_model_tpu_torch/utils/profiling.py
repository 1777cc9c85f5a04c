"""Tracing, memory and debugging utilities (counterpart of
``bicubic_interpolation_model_tpu/utils/profiling.py``):

- :func:`trace`: ``torch.profiler`` over a scope, written as a Chrome
  trace (view in Perfetto or ``chrome://tracing``);
- :func:`span`: a named range of the port's own host work, recorded only
  while a profiler records (the serving path's ``serve.upload``,
  ``model.step``, ``resize.dispatch``, ``serve.fetch.start``,
  ``serve.fetch.wait`` and ``stream.dispatch``, and inside ``model.step``
  the published ESRGAN's ``model.trunk`` and ``model.upsample``, listed
  in :data:`SPANS`);
- :func:`span_split`: a trace's host time and the card's idle time by
  the innermost span open on the host;
- :func:`device_memory_stats`: memory per visible card;
- :func:`debug_mode`: autograd anomaly detection with its NaN check for a
  scope;
- :func:`checked`: a function that raises on non-finite outputs.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch
from torch.autograd import profiler as _autograd_profiler

_DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "trace"


@contextlib.contextmanager
def trace(log_dir=_DEFAULT_TRACE_DIR):
    """Profile the scope (host ops, and the card's kernels when one is
    visible) and write ``trace.json`` into ``log_dir`` (made if missing) on
    exit; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    d = pathlib.Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(d / "trace.json"))


#: what :func:`span` returns while no profiler records: one context made
#: once, entered and left at no cost
_NO_SPAN = contextlib.nullcontext()

#: the port's spans, each with the layer whose host work it holds
SPANS = {"serve.upload": "serving",
         "model.step": "model step",
         "model.trunk": "model step",
         "model.upsample": "model step",
         "resize.dispatch": "resize dispatch, plans",
         "serve.fetch.start": "serving",
         "serve.fetch.wait": "serving",
         "stream.dispatch": "serving"}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a torch
    profiler records, so the range lands in the same trace as the kernels
    and copies it launches, on the same clock; otherwise one shared no-op
    context, so the untraced path pays one attribute read. Use it as
    ``with span(name):`` and never hold it open across a ``yield``: a
    range left open there would count the consumer's time."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_SPAN


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(spans) -> dict:
    """``{name: [(a, b), ...]}``: the intervals in which a span of that
    name is the innermost one open on its thread. Spans of one thread
    nest: a span's parent is the latest-starting one still open."""
    out: dict = {}
    by_tid: dict = {}
    for a, b, name, tid in spans:
        by_tid.setdefault(tid, []).append((a, -b, name))

    def close(span):
        a, b, name, children = span
        at = a
        for c0, c1 in _merged(children):
            if c0 > at:
                out.setdefault(name, []).append((at, c0))
            at = max(at, c1)
        if b > at:
            out.setdefault(name, []).append((at, b))

    for group in by_tid.values():
        stack = []                      # [start, end, name, children]
        for a, nb, name in sorted(group):
            while stack and stack[-1][1] <= a:
                close(stack.pop())
            if stack:
                stack[-1][3].append((a, min(-nb, stack[-1][1])))
            stack.append([a, -nb, name, []])
        while stack:
            close(stack.pop())
    return out


def span_split(events: list, window: str | None = None) -> dict:
    """The host time and the card's idle time of a Chrome trace's window
    (``export_chrome_trace``'s ``traceEvents``) by the port's spans.

    The window is the one ``record_function(window)`` range, or with
    ``window=None`` the trace's whole extent. The card is busy in the
    union of its kernels, copies and memsets, and idle in the rest of the
    window. Per span of :data:`SPANS` that the window holds: ``count``;
    ``self_s``, the spans' durations less the part their nested port
    spans cover; ``idle_s``, the idle time during which it was the
    innermost port span open on the host. ``idle_no_span_s`` is the idle
    time under no port span. Spans are clipped to the window; times are
    seconds."""
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    if window is None:
        t0 = min(iv(e)[0] for e in x)
        t1 = max(iv(e)[1] for e in x)
    else:
        wins = [iv(e) for e in x if e.get("cat") == "user_annotation"
                and e.get("name") == window]
        if len(wins) != 1:
            raise ValueError(f"the trace holds {len(wins)} spans named "
                             f"{window!r}")
        t0, t1 = wins[0]
    clip = lambda a, b: (max(a, t0), min(b, t1))
    port = [(*clip(*iv(e)), e["name"], e.get("tid")) for e in x
            if e.get("cat") == "user_annotation" and e.get("name") in SPANS
            and t0 <= float(e["ts"]) <= t1]
    busy = _merged(clip(*iv(e)) for e in x
                   if e.get("cat") in _DEVICE_CATS
                   and t0 <= float(e["ts"]) <= t1)
    edges = [t0] + [t for ab in busy for t in ab] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    own = _innermost(port)
    spans = {}
    for name in SPANS:
        held = _merged(own.get(name, []))
        count = sum(1 for s in port if s[2] == name)
        if count:
            spans[name] = {"count": count,
                           "self_s": sum(b - a for a, b in held) / 1e6,
                           "idle_s": _overlap(held, idle) / 1e6}
    idle_s = sum(b - a for a, b in idle)
    anywhere = _merged(ab for ivs in own.values() for ab in ivs)
    return {"window_s": (t1 - t0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "idle_s": idle_s / 1e6,
            "idle_no_span_s": (idle_s - _overlap(anywhere, idle)) / 1e6,
            "spans": spans}


def device_memory_stats() -> list[dict]:
    """Per visible card: bytes held by PyTorch's allocator now and at its
    peak (``torch.cuda.memory_stats``), and the card's total memory
    (``torch.cuda.mem_get_info``). Without a card, one CPU entry whose
    values are None, as the JAX function reports a host device."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Autograd anomaly detection for the scope: a backward that fails
    names the forward op that made its input, and with ``nans`` a backward
    op that returns NaN raises. Both flags are restored on exit. PyTorch
    has no Inf counterpart of ``jax_debug_infs``; :func:`checked` covers
    Inf in a function's outputs."""
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=nans)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*old)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def checked(fn):
    """``fn`` wrapped to raise FloatingPointError when a floating tensor in
    its outputs (nested in tuples, lists or dicts) holds NaN or Inf. This
    is weaker than the JAX function's ``checkify``, which also checks
    index bounds and NaN inside kernels as they run: here only what comes
    out is checked, once the function has returned."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', fn)} returned a non-finite "
                    f"tensor of shape {tuple(t.shape)}")
        return out

    return wrapper
