"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics. Everything that belongs to one of them
sits in files of its own under ``benchmark/``, found by that name:

- a configuration: ``configs/<config>.json``; its ``reference`` names a
  module of ``reference/`` and its ``system`` the program's class and
  arguments;
- a traffic mix: ``traffic/<traffic>.json`` (read by :mod:`.traffic`);
- a metric: ``metrics/<metric>.py``, whose ``read(ctx)`` returns the
  number or None where it finds nothing to read;
- a layer of the trace: ``layers/<layer>.json``;
- the counters of the program's hand-written kernels: ``counters.json``.

A later cell, mix, configuration or metric is a new file and a new entry;
no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, here=HERE) -> dict:
    path = pathlib.Path(here) / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def config(name: str, here=HERE) -> dict:
    return _json("configs", name, here)


def traffic(name: str, here=HERE) -> dict:
    from .traffic import check_mix
    return check_mix(_json("traffic", name, here))


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics in an
    untraced run, its per-layer metrics in a traced one."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here=HERE):
    """``read`` of ``metrics/<name>.py``, loaded from its file."""
    path = pathlib.Path(here) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no metric reader {path}")
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def counters(here=HERE) -> dict:
    return json.loads((pathlib.Path(here) / "counters.json").read_text())
