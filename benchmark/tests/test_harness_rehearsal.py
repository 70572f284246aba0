"""A tiny rehearsal of whole runs on the CPU: the window loop, the metrics
by name, the last line's keys, and the command's refusal without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.parametrize("workload", ["resnext_train_b512",
                                      "resnext_embed_b256"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys_and_metrics(workload, trace, monkeypatch):
    res = tiny.run_tiny(workload, monkeypatch, trace=trace)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(workload, trace)}
    got = set(res["metrics"])
    if trace:
        # a CPU trace holds no device operation: those readers return
        # nothing and the metrics are left out, never reported as 0
        assert got <= want and {m for m in want
                                if m.startswith("trunk_")} <= got
        assert "busy_s" not in res["device"]
    else:
        assert got == want
    for m in res["metrics"].values():
        assert m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_the_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "resnext_train_b512", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_command_refuses_outside_a_checkout(tmp_path):
    import shutil
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.SPEC, tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "resnext_train_b512", "--seed", "7", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
