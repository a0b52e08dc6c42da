"""BENCHMARK.json against the benchmark's contract, and the by-name
loaders that find each cell's files."""
import json
import os
import re

import pytest

from harness import cell as cellmod

MANIFEST = os.path.join(cellmod.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(MANIFEST) <= 64 * 1024


def test_names_units_and_lines(manifest):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(cellmod.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        # every key listed as changed is in the file as run, beside its
        # published value
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) == set(cfg.get("published", {}))
        for key in c["reduced"]:
            assert not re.search(r"(_dim|_rank|width|hidden|intermediate|ratio|size)$", key), key


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                    "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert cellmod.applies(e2e[m["moves"]], w, ())
        assert os.path.exists(cellmod.reader_path(m["name"])), m["name"]
        if m["name"].startswith("mfu"):
            assert m["source"] == "host_clock"   # the untraced window's rate
    for w in cells:   # every cell reports set-up, another end-to-end and a per-layer metric
        assert sum(cellmod.applies(m, w, ()) for m in manifest["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in manifest["per_layer"])


def test_every_cell_loads_with_its_files(manifest):
    for w in manifest["workloads"]:
        c = cellmod.load_cell(w["name"], 2 ** 31 + 11, 1.0)
        assert c.traffic["entry"] in ("embed", "search", "train")
        entry = c.entry
        assert entry.UNITS and callable(entry.setup) and callable(entry.end_to_end)
        assert c.limits and all(isinstance(v, float) for v in c.limits.values())
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names
        assert names - {"setup_s"} <= set(entry.end_to_end({entry.UNITS: 4, "calls": 2}, 2.0))
        for m in c.per_layer:
            assert callable(c.reader(m["name"]).read)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cellmod.load_cell("no.such_cell", 1, 1.0)


def test_applies_rule():
    assert cellmod.applies({"name": "x"}, "a", ())
    assert cellmod.applies({"name": "x", "workloads": ["a"]}, "a", ())
    assert not cellmod.applies({"name": "x", "workloads": ["b"]}, "a", ())
    assert cellmod.applies({"name": "y", "moves": "x"}, "a", {"x"})
    assert not cellmod.applies({"name": "y", "moves": "x"}, "a", {"z"})


def test_a_metric_without_its_own_reader_reads_its_prefix():
    assert cellmod.reader_path("device_idle.embed").endswith("metrics/device_idle.py")
    assert cellmod.reader_path("mfu.train").endswith("metrics/mfu.train.py")
