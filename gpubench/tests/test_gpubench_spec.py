"""Cells, configurations, traffic mixes and per-layer metrics are found
by name from their files, and BENCHMARK.json keeps to its contract."""

import json
import os
import re

import pytest

from gpubench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|length")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(w):
    cell = spec.Cell(BENCH, w["name"])
    assert cell.chips == 1
    p = cell.params
    for key in ("n_sequences", "length", "scores", "orientation", "sparsification", "snp_rate",
                "insertion_rate", "deletion_rate", "reverse_fraction", "id_prefix", "pool_jobs"):
        assert key in p, key
    assert set(p["check"]) == {"jobs", "pairs", "batch"}
    assert os.path.exists(os.path.join(spec.HERE, "workloads", w["traffic"] + ".json"))
    names = {m["name"] for m in cell.end_to_end}
    assert {"aln_per_s", "setup_s"} <= names
    assert cell.per_layer


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    read = spec.load_reader(m["name"])
    empty = {"jobs": 0, "span_s": {"cli": 0.0, "pairs": 0.0, "pipeline": 0.0}, "cells_counted": 0,
             "least_cells": 0, "least_s": 0.0, "busy_s": 0.0, "window_s": 0.0}
    assert read(empty) is None  # nothing to read: the metric is left out
    assert m["moves"] == "aln_per_s"


def test_names_units_and_sources():
    ends = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in ends
        layers.setdefault(m["layer"], 0)
    assert "setup_s" in ends
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("gpubench/configs/")
    cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert not any(WIDTHS.search(k) for k in c["reduced"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_file_is_small():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_merge_is_one_level_deep():
    cfg = {"a": 1, "check": {"jobs": 1, "pairs": 8, "batch": 8}}
    out = spec.merge(cfg, {"a": 2, "check": {"pairs": 2}})
    assert out == {"a": 2, "check": {"jobs": 1, "pairs": 2, "batch": 8}}
    assert cfg["check"]["pairs"] == 8
