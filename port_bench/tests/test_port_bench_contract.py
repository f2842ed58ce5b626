"""``BENCHMARK.json`` against the benchmark's contract, and the data-driven
layout: every cell, metric and piece is found by its name."""

import os
import re

import pytest

from port_bench.harness import HERE, ROOT, benchmark, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    b = benchmark()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "port_bench/run.py"]
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entries_and_names():
    b = benchmark()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert read_json("configs", c["name"] + ".json")["reduced"] == \
            c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))
        kind = read_json("traffic", w["traffic"] + ".json")["kind"]
        assert os.path.exists(os.path.join(HERE, "drivers", kind + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in moves
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_every_cell_reports_enough(cell):
    b = benchmark()
    mine = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    e2e = [m["name"] for m in mine(b["end_to_end"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert mine(b["per_layer"])
    for m in mine(b["per_layer"]):
        assert m["moves"] in e2e


def test_roofline_and_mfu_names():
    for m in benchmark()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]
