"""The benchmark's files: found by name, and within the benchmark's limits."""
import json
import math
import re

import pytest

import tiny  # noqa: F401  (puts bench/ and src/ on the path)
from harness.cells import BENCH, ROOT, load_cell, load_json, reader

BM = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# the widths of the two configurations, which no cut may name
WIDTHS = {"hidden_size", "intermediate_size", "head_dim", "d_model",
          "d_state", "headdim", "expand", "d_conv", "chunk_size",
          "d_intermediate"}


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"]
    assert BM["command"] == ["python3", "bench/run.py"]
    assert 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_found_by_name(cell):
    c = load_cell(cell, BM)
    assert c.config["source"] == next(
        x["source"] for x in BM["configs"] if x["name"] == c.spec["config"])
    assert c.traffic["runner"] == "train"
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "train_tokens_per_s"} <= names
    assert c.per_layer
    assert set(c.cell["checks"]) >= {"grad_gap", "update_gap",
                                     c.cell["guarantee"]["name"]}
    for lim in c.cell["checks"].values():
        assert lim["limit"] < lim["upper"]
        assert lim["lower"] is None or lim["lower"] < lim["limit"]
    assert c.cell["plan"]["asked_bytes"] > 0
    assert c.spec["chips"] == 1


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no.such.cell", BM)


@pytest.mark.parametrize("cfg", BM["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = ROOT / cfg["file"]
    assert path.relative_to(BENCH)
    data = load_json(path)
    assert data["source"] == cfg["source"]
    assert sorted(cfg["reduced"]) == sorted(data["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key) and key not in WIDTHS, key
        assert key in data
    assert len(cfg["reduced"]) <= 16


def test_names_units_and_sources():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for m in BM[group]:
            assert NAME.match(m["name"]), m["name"]
            assert (group, m["name"]) not in seen
            seen.add((group, m["name"]))
            for k in ("why", "layer"):
                if k in m:
                    assert 1 <= len(m[k]) <= 200 and "\n" not in m[k]
    e2e = {m["name"] for m in BM["end_to_end"]}
    cells = {w["name"] for w in BM["workloads"]}
    for m in BM["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and m["moves"] in e2e
        moved = next(x for x in BM["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("metric", BM["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_what_benchmark_says(metric):
    mod = reader(metric["name"])
    assert mod.LAYER == metric["layer"]
    assert mod.SOURCE == metric["source"]
    assert mod.MOVES == metric["moves"]
    assert mod.UNIT == metric["unit"] and mod.BETTER == metric["better"]
    assert set(mod.WORKLOADS) <= set(metric["workloads"])
    assert mod.read({}) is None          # nothing to read: nothing returned


def test_shares_never_zero_and_within_peak():
    r = {"mfu": 0.0, "trace_busy_s": 0.0, "trace_window_s": 1.0}
    assert reader("train_mfu").read(r) is None
    assert reader("device_idle_share").read(r) is None
    r = {"mfu": 0.25, "trace_busy_s": 0.75, "trace_window_s": 1.0,
         "trace_copy_s": 0.5}
    assert math.isclose(reader("train_mfu").read(r), 25.0)
    assert math.isclose(reader("device_idle_share").read(r), 25.0)
    assert math.isclose(reader("copy_busy_share").read(r), 50.0)


def test_check_time_fits():
    runs = 2 + 14 * 24
    total = runs * (BM["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
