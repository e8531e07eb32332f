"""BENCHMARK.json keeps to its contract, and the harness finds every
configuration, mix and metric it names by file name."""

import json
import os
import re

import pytest

from benchmark.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_and_units(bench):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_and_cells_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == w["config"] + "." + w["traffic"]
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        cfg = registry.config(w["config"])
        mix = registry.mix(w["traffic"])
        assert callable(registry.loop(mix["loop"]))
        assert cfg["name"] == w["config"]
        used.add(w["config"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        assert c["reduced"] == registry.config(c["name"])["reduced"] == []
        assert c["source"] == registry.config(c["name"])["source"]
    assert used == {c["name"] for c in bench["configs"]}


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        reported = registry.metrics_of(bench, cell, "end_to_end")
        assert len(reported) >= 2
        assert registry.metrics_of(bench, cell, "per_layer")


def test_per_layer_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(registry.metric_reader(m["name"]))
        for cell in m["workloads"]:
            moved = registry.metrics_of(bench, cell, "end_to_end")
            assert m["moves"] in {x["name"] for x in moved}, (m, cell)
        assert 0 < len(m["layer"]) <= 200


NUMBERS = {"train": {"loss_gap", "grad_rel_l2", "last_grad_rel_l2",
                     "update_gap"},
           "open": {"frame_rms_lsb"}, "closed": {"frame_rms_lsb"}}


def test_config_limits_cover_the_numbers(bench):
    for w in bench["workloads"]:
        limits = registry.config(w["config"])["limits"]
        numbers = NUMBERS[registry.mix(w["traffic"])["loop"]]
        assert numbers <= set(limits), w["name"]
        assert all(limits[n] > 0 for n in numbers)


def test_files_under_paths_are_named_from_names():
    for dirpath, _, files in os.walk(os.path.join(registry.ROOT,
                                                  "benchmark")):
        if "_cache" in dirpath or "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), registry.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_json_files_parse():
    for kind in ("configs", "traffic"):
        d = os.path.join(registry.BENCH_DIR, kind)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as h:
                json.load(h)
