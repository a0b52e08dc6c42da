"""One cell of `BENCHMARK.json` and the files it is made of, found by name.

- a configuration: the file its `configs` entry names;
- a traffic mix: `traffic/<traffic>.json`, whose `entry` names the
  driver `entries/<entry>.py` (the generator and the timed call);
- the limits that decide `correct`: `limits/<cell>.json`;
- a per-layer metric: its reader `metrics/<name>.py`, or, where there is
  none, the reader its metrics share, `metrics/<name up to the first
  dot>.py` (`device_idle.py` reads `device_idle.embed` and
  `device_idle.search`).

A later cell, mix, configuration or metric is added as files and
manifest entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric is reported in `cell`: listed under its
    `workloads`, or, without that key, an end-to-end metric everywhere and
    a per-layer one wherever its `moves` metric is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int
    device: str = "cuda"

    @property
    def entry(self):
        name = self.traffic["entry"]
        return load_module(os.path.join(BENCH, "entries", f"{name}.py"), f"entry_{name}")

    def reader(self, metric: str):
        path = reader_path(metric)
        return load_module(path, "metric_" + os.path.basename(path)[:-3].replace(".", "_"))


def reader_path(metric: str) -> str:
    """The file that reads a per-layer metric: its own, else the one that
    the metrics named `<prefix>.*` share."""
    own = os.path.join(BENCH, "metrics", f"{metric}.py")
    if os.path.exists(own):
        return own
    return os.path.join(BENCH, "metrics", f"{metric.split('.', 1)[0]}.py")


def load_cell(workload: str, seed: int, seconds: float, manifest_path: str = None) -> Cell:
    manifest = load_json(manifest_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(BENCH, "limits", f"{workload}.json"))
    e2e = [m for m in manifest["end_to_end"] if applies(m, workload, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if applies(m, workload, names)]
    return Cell(workload, int(seed), float(seconds), config, traffic, limits, e2e, layer,
                int(w["chips"]))
