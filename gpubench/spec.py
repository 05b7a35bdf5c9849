"""Finds a cell's parts by name: the cell in BENCHMARK.json, its
configuration file, its traffic mix (`workloads/<traffic>.json`) and the
reader of each per-layer metric (`metrics/<name>.py`). A later cell,
configuration or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(config: dict, traffic: dict) -> dict:
    """A job's parameters: the configuration's, with the traffic mix's
    on top (nested groups merged one level deep)."""
    out = dict(config)
    for k, v in traffic.items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One workload of BENCHMARK.json, resolved."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        self.entry = _named(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg = _named(bench["configs"], self.entry["config"], "config")
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(os.path.join(HERE, "workloads", self.entry["traffic"] + ".json"))
        self.params = merge(self.config, self.traffic)
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(metric_name: str):
    """The `read(ctx)` function of `metrics/<metric_name>.py`."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
