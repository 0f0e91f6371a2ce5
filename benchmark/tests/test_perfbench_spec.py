"""BENCHMARK.json against the benchmark's contract, and everything it
names found by name."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in bench["command"])
    assert os.path.isfile(os.path.join(ROOT, bench["command"][1]))


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for e in bench["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for name in names:
        assert NAME.match(name), name
    for text in ([c["source"] for c in bench["configs"]] + [c["why"] for c in bench["configs"]]
                 + [w["why"] for w in bench["workloads"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        mine = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and any(m["name"] == "setup_s" for m in mine)
        layer = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in mine}


def test_everything_is_found_by_name(bench):
    import importlib

    for c in bench["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"]
        assert os.path.isfile(os.path.join(BENCH, "entries", conf["entry"] + ".py"))
        judge = importlib.import_module("references." + conf["reference"])
        assert set(judge.judge([], conf["limits"])) == set(conf["limits"])
    for w in bench["workloads"]:
        t = json.load(open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")))
        assert t["streams"] >= 1 and t["frames"] >= 8 and len(t["scene_seeds"]) >= 2
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    layers = {m["layer"] for m in bench["per_layer"]}
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        perf = fh.read()
    for layer in layers:
        assert f"**{layer}**" in perf, layer
