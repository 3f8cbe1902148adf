"""BENCHMARK.json and every file it names: present, found by name, and
within the contract's limits on names, units and sizes."""

import json
import re

import pytest

from eebench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["eebench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (section, entry["name"]) not in seen
            seen.add((section, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_file_resolves_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("eebench/")
        conf = json.loads(path.read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        used.add(w["config"])
        traffic = json.loads((ROOT / "eebench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "eebench" / "drivers" / f"{traffic['driver']}.py").is_file()
        cell = json.loads((ROOT / "eebench" / "workloads" / f"{w['name']}.json").read_text())
        assert cell["checks"]
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        reported = {m["name"] for m in e2e}
        assert "setup_s" in reported
        assert len(reported & {"solves_per_s", "replan_solves_per_s"}) == 1
        assert layer
    assert used == names
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = harness.layer_reader(metric)
    assert (mod.UNIT, mod.MOVES, mod.LAYER) == (m["unit"], m["moves"], m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_workloads_of_metrics_report_what_they_move():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            e2e, _ = harness.cell_metrics(BENCH, cell)
            if m in BENCH["per_layer"]:
                assert m["moves"] in {e["name"] for e in e2e}


def test_file_names_use_name_characters():
    for path in (ROOT / "eebench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200


def test_traffic_files_are_data():
    for path in (ROOT / "eebench" / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv"), path
        json.loads(path.read_text())
