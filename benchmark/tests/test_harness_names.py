"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys,
the one-line strings and their lengths."""

import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    b = harness.spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= len(b["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


def test_names_units_and_keys():
    b = harness.spec()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in b["configs"]] + [
        x["name"] for x in b["workloads"]] + [
        x["name"] for x in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    b = harness.spec()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(w["name"], False, b)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(w["name"], True, b)


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in harness.spec()["workloads"]]
    assert len(pairs) == len(set(pairs))
