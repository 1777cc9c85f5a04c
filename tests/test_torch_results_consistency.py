"""The port's card record against its README subsection and its refresh
(counterpart of ``tests/test_results_consistency.py``, which holds the JAX
package's ``results/`` to its README section).

- every ``results_torch/*.json`` carries a ``_provenance`` stamp of a card
  run: backend ``cuda``, an NVIDIA card's name and power limit in watts, a
  CUDA build of torch, the CUDA version, the source revision, the code's
  64-hex ``source_sha256`` and the date;
- README's "Measured results on the card" is exactly what
  ``scripts/torch_render_readme_results.py`` renders from those files
  (``--check``), and states the files' own numbers (spot-checked: the
  bicubic 1080p -> 4x row and both microbatch thresholds);
- every section of ``scripts/torch_refresh_results.py`` has its committed
  files; the refresh refuses a table of another backend, card or code,
  picks sections only on the CPU, and without a card it exits 1; its
  ``--cpu`` run in a copy of the checkout
  leaves the committed files byte for byte as they were.

No test here holds a file's ``source_sha256`` to this checkout's
``configs.source_sha256()``. Such a test would fail on every later PR
that changes a measured source before the record is refreshed on the
card, as ``test_stamps_not_older_than_measured_code`` does for the JAX
package's record. Freshness is reported instead, by the refresh before it
runs and by ``chip_smoke.py``'s ``results`` phase; that the files share
one digest is ``tests/test_torch_serving_policy.py``'s.
"""

import datetime
import hashlib
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from bicubic_interpolation_model_tpu_torch.bench import configs

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_DIR = ROOT / "results_torch"
FILES = sorted(p.name for p in CARD_DIR.glob("*.json"))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def refresh():
    return _script("torch_refresh_results")


@pytest.fixture(scope="module")
def render():
    return _script("torch_render_readme_results")


@pytest.mark.parametrize("name", FILES)
def test_every_file_carries_a_card_stamp(name):
    prov = json.loads((CARD_DIR / name).read_text())["_provenance"]
    assert prov["backend"] == "cuda"
    card, power = prov["card"].rsplit(", ", 1)
    assert card.startswith("NVIDIA ") and re.fullmatch(r"\d+\.\d+ W", power)
    assert "+cu" in prov["torch"] and re.fullmatch(r"\d+\.\d+", prov["cuda"])
    assert prov["commit"]
    assert re.fullmatch(r"[0-9a-f]{64}", prov["source_sha256"])
    datetime.datetime.strptime(prov["date"], "%Y-%m-%dT%H:%M:%SZ")


def test_readme_card_results_match_the_files():
    res = subprocess.run(
        [sys.executable, "scripts/torch_render_readme_results.py", "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_card_markers_hold_no_tpu_marker(render):
    """The TPU renderer splits README on its own markers: the card's may
    not contain them, and lie before them."""
    jax_render = (ROOT / "scripts" / "render_readme_results.py").read_text()
    jax_markers = re.findall(r'"(<!-- results:[^"]*-->)"', jax_render)
    assert len(jax_markers) == 2
    text = (ROOT / "README.md").read_text()
    for marker in jax_markers:
        assert marker not in render.BEGIN and marker not in render.END
        assert text.index(render.END) < text.index(marker)


def test_rendering_states_the_files_numbers(render):
    """The bicubic 1080p -> 4x row reads the file's impl, ms, GPix/s and
    delta; each curve's threshold is the smallest measured size at which
    grouping did not win in every call."""
    text = render.render()
    mt = json.loads((CARD_DIR / "method_throughput.json").read_text())
    b = mt["bicubic"]
    assert (f"| bicubic ({b['impl']}) | {render.num(b['ms_per_frame'])} | "
            f"{render.num(b['gpix_per_s'])} | {b['max_u8_delta']} |") in text
    calls = [json.loads((CARD_DIR / f"latency_curve_call{i}.json")
                        .read_text()) for i in (1, 2, 3)]
    for curve, rows_of in (("classical", lambda t: t["rows"]),
                           ("learned", lambda t: t["learned"]["rows"])):
        tables = [rows_of(c) for c in calls]
        sizes = sorted(tables[0], key=configs.size_px)
        lost = [s for s in sizes
                if not all(configs.batching_wins(t[s]) for t in tables)]
        want = (configs.size_px(lost[0]) if lost
                else configs.size_px(sizes[-1]) + 1)
        assert (f"gives the {curve} `MICROBATCH_THRESHOLD_PX` = {want}."
                in text)


def test_every_refresh_section_has_its_committed_files(refresh):
    for name, sec in refresh.SECTIONS.items():
        assert sec.commits, name
        for dest in sec.commits:
            data = json.loads((CARD_DIR / dest).read_text())
            assert data["_provenance"]["backend"] == "cuda", (name, dest)
    committed = {d for s in refresh.SECTIONS.values() for d in s.commits}
    assert committed == set(FILES)


def test_refresh_refuses_a_table_of_another_run(refresh):
    sha = "0" * 64
    card = {"_provenance": {"backend": "cuda", "source_sha256": sha,
                            "card": "NVIDIA H100 80GB HBM3, 700.00 W"}}
    assert refresh.refusal(card, sha, cpu=False) is None
    assert refresh.refusal(card, "1" * 64, cpu=False)
    assert refresh.refusal(card, sha, cpu=True)
    cpu = {"_provenance": {"backend": "cpu", "source_sha256": sha,
                           "card": "cpu (no card: nothing measured)"}}
    assert refresh.refusal(cpu, sha, cpu=True) is None
    assert refresh.refusal(cpu, sha, cpu=False)
    unnamed = {"_provenance": {**card["_provenance"],
                               "card": "nvidia-smi unavailable"}}
    assert refresh.refusal(unnamed, sha, cpu=False)
    assert refresh.refusal({}, sha, cpu=False)


def test_refresh_without_a_card_exits_1(refresh, capsys):
    assert refresh.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--only", "--skip"])
def test_refresh_picks_sections_only_with_cpu(refresh, flag, capsys):
    """A card run refreshes every section: a part of a snapshot copied
    beside the rest of an older one would give ``results_torch/`` two
    digests."""
    with pytest.raises(SystemExit) as e:
        refresh.main([flag, "bench_configs"])
    assert e.value.code == 2
    assert "go with --cpu" in capsys.readouterr().err


def _digests(d):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.glob("*.json"))}


def test_refresh_cpu_run_copies_nothing(tmp_path):
    """``--cpu --only bench_configs`` in a copy of the port, its scripts
    and ``results_torch/``: the producer's stamped CPU table is written
    under the copy's ``build/``, and neither ``results_torch/`` changes."""
    before = _digests(CARD_DIR)
    shutil.copytree(ROOT / "bicubic_interpolation_model_tpu_torch",
                    tmp_path / "bicubic_interpolation_model_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "scripts").mkdir()
    for p in (ROOT / "scripts").glob("torch_*.py"):
        shutil.copy(p, tmp_path / "scripts")
    shutil.copytree(CARD_DIR, tmp_path / "results_torch")
    res = subprocess.run(
        [sys.executable, "scripts/torch_refresh_results.py", "--cpu",
         "--only", "bench_configs", "--commit", "test"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "bench_configs: ok" in res.stdout
    table = json.loads((tmp_path / "build" / "results" / "bench_configs.json")
                       .read_text())
    prov = table["_provenance"]
    assert prov["backend"] == "cpu" and prov["commit"] == "test"
    assert prov["source_sha256"] == configs.source_sha256()
    assert _digests(tmp_path / "results_torch") == before
    assert _digests(CARD_DIR) == before
