"""The port's spans (``utils/profiling.span`` at the serving path's layer
boundaries) on the CPU: off without a profiler, and under one exactly the
spans that each entry point opens, nested on the host thread, none left
open across a ``yield``; ``profiling.span_split`` on a hand-made trace;
``scripts/torch_span_split.py --cpu``."""

import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bicubic_interpolation_model_tpu_torch.serving import (ModelUpscaler,
                                                           Upscaler)
from bicubic_interpolation_model_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "bicubic_interpolation_model_tpu_torch"
NAMES = set(profiling.SPANS)
OUTER = "__call__"
_CALL = ["serve.upload", "model.step", "serve.fetch.start",
         "serve.fetch.wait"]
_RESIZE = ["serve.upload", "resize.dispatch", "serve.fetch.start",
           "serve.fetch.wait"]
#: the spans one call of each entry point opens (a stream: per dispatch)
PATHS = {"ModelUpscaler.__call__": _CALL, "ModelUpscaler.batch": _CALL,
         "ModelUpscaler.stream": ["stream.dispatch"] + _CALL,
         "Upscaler.__call__": _RESIZE, "Upscaler.batch": _RESIZE,
         "Upscaler.stream": ["stream.dispatch"] + _RESIZE}


@pytest.fixture(scope="module")
def learned():
    return ModelUpscaler(str(ROOT / "model" / "wp-1e-3-120"), device="cpu")


def _frames(n, h=8, w=10, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8)


def _server(kind, learned):
    if kind == "learned":
        return learned
    return Upscaler(scale=4, method=kind, device="cpu")


#: (server kind, entry, microbatch): ``entry`` names the path in
#: ``PATHS`` with the server's class
CASES = [("learned", "__call__", None), ("learned", "batch", None),
         ("learned", "stream", None), ("learned", "stream", 3),
         ("bicubic", "__call__", None), ("bicubic", "batch", None),
         ("bicubic", "stream", None), ("bicubic", "stream", 3),
         ("adaptive", "__call__", None), ("adaptive", "batch", None),
         ("adaptive", "stream", None)]


def _ids(case):
    return "-".join(str(p) for p in case)


def _drive(server, entry, microbatch, frames):
    if entry == "__call__":
        return [server(frames[0])]
    if entry == "batch":
        return [server.batch(frames)]
    return list(server.stream(iter(frames), microbatch=microbatch))


def _path(kind, entry):
    cls = "ModelUpscaler" if kind == "learned" else "Upscaler"
    return PATHS[f"{cls}.{entry}"]


# -- off: no profiler, no span -----------------------------------------

@pytest.mark.parametrize("name", sorted(NAMES) + ["anything else"])
def test_span_is_the_one_shared_no_op_without_a_profiler(name):
    assert profiling.span(name) is profiling._NO_SPAN
    with profiling.span(name):
        pass


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_no_path_enters_record_function_without_a_profiler(case, learned,
                                                           monkeypatch):
    kind, entry, microbatch = case

    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    out = _drive(_server(kind, learned), entry, microbatch, _frames(3))
    assert out and all(o.dtype == np.uint8 for o in out)


# -- on: the spans of each path, nested ----------------------------------

def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _parent(span, spans):
    """The innermost span of ``spans`` that holds ``span``, or None."""
    a, b, _ = span
    holders = [s for s in spans if s is not span and s[0] <= a
               and b <= s[1] and (s[1] - s[0]) >= (b - a)]
    return min(holders, key=lambda s: s[1] - s[0], default=None)


def _traced(server, entry, microbatch, frames, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            out = _drive(server, entry, microbatch, frames)
    return out, _annotations(prof, tmp_path)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_path_opens_the_spans_of_spans_json_nested(case, learned,
                                                        tmp_path):
    kind, entry, microbatch = case
    server = _server(kind, learned)
    frames = _frames(3)
    _drive(server, entry, microbatch, frames)          # plans cached
    out, spans = _traced(server, entry, microbatch, frames, tmp_path)
    want = _path(kind, entry)
    # one dispatch a frame, or one for the group of 3
    per = 3 if entry == "stream" and microbatch is None else 1
    got = sorted(s[2] for s in spans if s[2] in NAMES)
    assert got == sorted(want * per)
    outer = [s for s in spans if s[2] == OUTER]
    assert len(outer) == 1
    port = [s for s in spans if s[2] in NAMES] + outer
    for s in port[:-1]:
        parent = _parent(s, port)
        assert parent is not None, s
        inner = entry == "stream" and s[2] not in ("stream.dispatch",
                                                   "serve.fetch.wait")
        assert parent[2] == ("stream.dispatch" if inner else OUTER), s
    if kind == "learned":
        assert "resize.dispatch" not in got
    else:
        assert "model.step" not in got


@pytest.mark.parametrize("kind", ["learned", "bicubic", "adaptive"])
def test_no_port_span_is_open_across_a_yield(kind, learned, tmp_path):
    server = _server(kind, learned)
    frames = _frames(4, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        it = server.stream(iter(frames), microbatch=None)
        first = next(it)
        with record_function("consumer"):
            np.array(first, copy=True)
        rest = list(it)
    assert 1 + len(rest) == len(frames)
    spans = _annotations(prof, tmp_path)
    consumer = [s for s in spans if s[2] == "consumer"]
    assert len(consumer) == 1
    port = [s for s in spans if s[2] in NAMES]
    assert port
    a, b, _ = consumer[0]
    assert not [s for s in port if s[0] < b and a < s[1]]


def test_span_names_in_the_port_are_profiling_spans():
    used = set()
    for path in PORT.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert used == NAMES
    assert set(profiling.SPANS.values()) == {
        "serving", "model step", "resize dispatch, plans"}
    for spans in PATHS.values():
        assert set(spans) <= NAMES


# -- span_split on a hand-made trace -------------------------------------

def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _ann(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid)


#: two calls: a learned one under ``__call__`` and a stream frame under
#: ``stream.next`` whose dispatch holds the upload, the resize dispatch
#: and the fetch's start; a span before the window and a host op
TRACE = [
    _ann("window", 100, 200),
    _x("gpu_user_annotation", "window", 100, 200),
    _ann("serve.upload", 40, 10),
    _x("kernel", "before_the_window", 40, 30),
    _ann("__call__", 100, 80),
    _ann("host_result", 180, 5),
    _ann("stream.next", 185, 75),
    _x("cpu_op", "aten::copy_", 102, 8),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 105, 6),
    _x("kernel", "sm80_xmma_fprop_implicit_gemm_f32f32", 115, 20),
    _x("kernel", "void packed_tail_fused_kernel<false>", 135, 15),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 150, 26),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 190, 5),
    _x("kernel", "void resize_plan_kernel<4, true>", 200, 10),
    _x("gpu_memset", "Memset (Device)", 212, 20),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 230, 20),
    _ann("serve.upload", 101, 10),
    _ann("model.step", 111, 30),
    _ann("serve.fetch.start", 141, 5),
    _ann("serve.fetch.wait", 146, 32),
    _ann("stream.dispatch", 186, 44),
    _ann("serve.upload", 187, 8),
    _ann("resize.dispatch", 195, 20),
    _ann("serve.fetch.start", 215, 10),
    _ann("serve.fetch.wait", 232, 26),
    _ann("serve.fetch.wait", 290, 30),       # clipped at the window's end
]
# busy: [105, 111] [115, 176] [190, 195] [200, 210] [212, 250] = 120 us;
# idle: [100, 105] [111, 115] [176, 190] [195, 200] [210, 212] [250, 300]
SELF_US = {"serve.upload": 18, "model.step": 30, "resize.dispatch": 20,
           "serve.fetch.start": 15, "serve.fetch.wait": 58 + 10,
           "stream.dispatch": 6}       # 44 less 8 + 20 + 10 nested
IDLE_US = {"serve.upload": 4 + 3, "model.step": 4,
           "resize.dispatch": 5 + 2, "serve.fetch.start": 0,
           "serve.fetch.wait": 2 + 8 + 10, "stream.dispatch": 1}
COUNT = {"serve.upload": 2, "model.step": 1, "resize.dispatch": 1,
         "serve.fetch.start": 2, "serve.fetch.wait": 3,
         "stream.dispatch": 1}


@pytest.mark.parametrize("name", sorted(SELF_US))
def test_span_split_per_span(name):
    got = profiling.span_split(TRACE, "window")["spans"][name]
    assert got["count"] == COUNT[name]
    assert got["self_s"] == pytest.approx(SELF_US[name] / 1e6)
    assert got["idle_s"] == pytest.approx(IDLE_US[name] / 1e6)


def test_span_split_window_busy_and_idle():
    got = profiling.span_split(TRACE, "window")
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(120e-6)
    assert got["idle_s"] == pytest.approx(80e-6)
    assert got["idle_no_span_s"] == pytest.approx((1 + 8 + 32) / 1e6)
    assert got["idle_no_span_s"] + sum(
        v["idle_s"] for v in got["spans"].values()) == pytest.approx(
            got["idle_s"])


def test_span_split_spans_of_two_threads_nest_apart():
    """A span on another thread is no parent of this thread's spans."""
    events = [_ann("window", 0, 100), _ann("model.step", 10, 50, tid=1),
              _ann("serve.upload", 20, 10, tid=2)]
    got = profiling.span_split(events, "window")["spans"]
    assert got["model.step"]["self_s"] == pytest.approx(50e-6)
    assert got["serve.upload"]["self_s"] == pytest.approx(10e-6)


def test_span_split_whole_trace_without_a_window_and_one_window_asked():
    events = [_ann("serve.upload", 10, 10), _x("kernel", "k", 15, 10)]
    got = profiling.span_split(events)
    assert got["window_s"] == pytest.approx(15e-6)
    assert got["spans"]["serve.upload"]["idle_s"] == pytest.approx(5e-6)
    with pytest.raises(ValueError, match="0 spans named 'window'"):
        profiling.span_split(events, "window")


# -- the script, on the CPU ----------------------------------------------

def _script():
    path = ROOT / "scripts" / "torch_span_split.py"
    spec = importlib.util.spec_from_file_location("torch_span_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("path", ["wp_div2k_call", "bicubic_1080p_call",
                                  "wp_540p_stream"])
def test_span_split_script_on_the_cpu(path, capsys):
    assert _script().main(["--cpu", "--path", path, "--frames", "2"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["path"] == path and row["frames"] == 2
    assert row["busy_ms"] == 0 and row["idle_ms"] == row["window_ms"]
    assert len(row["traced_ms"]) == len(row["traced_no_spans_ms"]) == 2
    kind, entry = _script().PATHS[path][:2]
    cls = "ModelUpscaler" if kind == "learned" else "Upscaler"
    want = PATHS[f"{cls}.{'__call__' if entry == 'call' else 'stream'}"]
    assert set(row["spans"]) == set(want)
