"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.lib import check
from portbench.lib.manifest import BENCH, ROOT, Cell, load_manifest, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per_token",
               "channels", "width")
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str, limit: int = 200) -> bool:
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_sources():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not any(w in k for w in WIDTH_WORDS) and not k.endswith(("_dim", "_rank"))
                   for k in c["reduced"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in MANIFEST["workloads"]} == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    assert c.spec["name"] == cell and c.spec["config"] == next(
        w["config"] for w in MANIFEST["workloads"] if w["name"] == cell)
    assert c.spec["why"] == next(w["why"] for w in MANIFEST["workloads"] if w["name"] == cell)
    assert hasattr(c.entry, "setup") and hasattr(c.entry, "reference")
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer()
    for m in e2e - {"setup_s", "peak_mem_gib"}:
        assert c.spec["end_to_end"][m] in ("ms_per_step", "mega_units_per_s")
    for m in c.per_layer():
        assert m["moves"] in e2e  # the cell reports what the metric moves
        assert callable(reader(m["name"]).read)
    assert c.spec["limits"] and set(c.spec["limits"]) <= set(check.NUMBERS)


def test_config_files_hold_their_reduced_keys():
    for c in MANIFEST["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/") and body["name"] == c["name"]
        assert set(body["reduced"]) == set(c["reduced"])


def test_harness_names_no_cell_config_or_metric():
    text = (BENCH / "run.py").read_text() + (BENCH / "lib" / "manifest.py").read_text()
    named = CELLS + [c["name"] for c in MANIFEST["configs"]] + [m["name"] for m in MANIFEST["per_layer"]]
    named += [m["name"] for m in MANIFEST["end_to_end"] if m["name"] not in ("setup_s", "peak_mem_gib")]
    assert not [n for n in named if n in text]


def test_command_names_no_file_outside_paths():
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py") or "/" in word:
            assert any(word.startswith(p) for p in MANIFEST["paths"])


def test_reference_imports_nothing_of_the_program():
    bad = ("voxe_tpu", "voxe_tpu_torch", "jax", "jaxlib", "flax", "optax")
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in bad, (path.name, m)
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench."):
                assert node.module.split(".")[1] in ("reference", "lib"), (path.name, node.module)
    for path in (BENCH / "lib").glob("*.py"):
        if path.name == "program.py":
            continue  # the glue that builds the program's objects
        assert "voxe_tpu" not in path.read_text(), path.name


def test_paths_hold_only_the_benchmark():
    assert MANIFEST["paths"] == ["portbench"]
    assert Path(BENCH).name == "portbench" and not (ROOT / "portbench_torch").exists()
