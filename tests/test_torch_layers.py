"""The port's layers import one way, bottom to top: each module's in-package
imports, read with ``ast`` from the sources (nothing is imported), go down
the order below, stay inside the module's own subpackage, or go sideways
to a peer the order names. ``train/checkpoint.py``, the msgpack format,
is a leaf any layer may read.

1. runtime, utils
2. core
3. ops
4. models, data
5. serving, parallel, evaluation, train
6. bench, cli, entry
"""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "bicubic_interpolation_model_tpu_torch"

LAYER = {"runtime": 1, "utils": 1, "core": 2, "ops": 3, "models": 4,
         "data": 4, "serving": 5, "parallel": 5, "evaluation": 5,
         "train": 5, "bench": 6, "cli": 6, "entry": 6}
#: imports across subpackages of one layer that the order allows
PEERS = {("utils", "runtime"), ("parallel", "train"), ("cli", "bench")}
LEAF = f"{PKG}.train.checkpoint"
#: private names that once crossed module lines: no module imports them
PRIVATE = ("_load_model_any", "_conv_precision", "_full_f32_matmul",
           "_tail_operands", "_tree", "_is_weight_predictor", "_flat_mats",
           "_merged_map_from_mats", "_packed_phase_tail",
           "_packed_merged_map", "_tail_graph")


def _modules():
    """``(module name, is a package, parsed tree)`` of every source."""
    out = []
    for path in sorted((ROOT / PKG).rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        is_pkg = parts[-1] == "__init__"
        name = ".".join(parts[:-1] if is_pkg else parts)
        out.append((name, is_pkg, ast.parse(path.read_text(), str(path))))
    return out


def _imports(name, is_pkg, tree):
    """``(target module, imported names, line)`` of each in-package
    import, relative ones resolved."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level:
                base = name.split(".")
                base = base[:len(base) - node.level + (1 if is_pkg else 0)]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                target = node.module or ""
            names = [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == PKG:
                    yield alias.name, [], node.lineno
            continue
        else:
            continue
        if target.split(".")[0] != PKG:
            continue
        # from ..train import checkpoint: a name may be a module itself
        subs = [n for n in names if f"{target}.{n}" in NAMES]
        for n in subs:
            yield f"{target}.{n}", [], node.lineno
        if len(subs) < len(names):
            yield target, [n for n in names if n not in subs], node.lineno


def _unit(module: str) -> str | None:
    parts = module.split(".")
    return parts[1] if len(parts) > 1 else None


MODULES = _modules()
NAMES = {name for name, _, _ in MODULES}
#: (module, target module, imported names, line) of every in-package import
IMPORTS = [(name, *imp) for name, is_pkg, tree in MODULES
           for imp in _imports(name, is_pkg, tree)]


def test_every_subpackage_has_a_layer():
    units = {_unit(name) for name, _, _ in MODULES} - {None}
    assert units == set(LAYER), units ^ set(LAYER)


def test_imports_go_down_or_to_an_allowed_peer():
    wrong = []
    for name, target, _, line in IMPORTS:
        src, dst = _unit(name), _unit(target)
        if (src is None or dst == src or target == LEAF
                or LAYER[dst] < LAYER[src] or (src, dst) in PEERS):
            continue
        wrong.append(f"{name}:{line} -> {target}")
    assert not wrong, "\n".join(wrong)


def test_the_checkpoint_format_is_a_leaf():
    assert not [imp for imp in IMPORTS if imp[0] == LEAF]


@pytest.mark.parametrize("name", sorted(PRIVATE))
def test_no_module_imports_a_moved_private_name(name):
    users = [f"{mod}:{line} from {target}"
             for mod, target, names, line in IMPORTS if name in names]
    assert not users, "\n".join(users)


def _is_type_name(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "__name__"
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Name)
            and node.value.func.id == "type")


def test_no_route_is_decided_by_a_class_name():
    found = [f"{name}:{node.lineno}" for name, _, tree in MODULES
             for node in ast.walk(tree) if isinstance(node, ast.Compare)
             and any(_is_type_name(x)
                     for x in [node.left, *node.comparators])]
    assert not found, found
