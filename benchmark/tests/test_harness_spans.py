"""The readers of the program's spans in a tiny traced rehearsal on the
CPU: every new ``*_ms`` metric of the cell is reported above 0 (host time
there) and ``syncs_per_step`` is left out (nothing is counted on the
CPU); against a program without the span store, every reader returns
None and the run still completes."""

import types

import pytest

from benchmark import harness
from benchmark.tests import tiny

NEW = {"resnext_train_b512": ["augment_ms.train", "text_ms.train",
                              "loss_ms.train", "backward_ms.train",
                              "optimizer_ms.train", "host_ms.train"],
       "resnext_embed_b256": ["host_ms.embed"]}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_span_metrics_in_a_traced_cpu_run(workload, monkeypatch):
    res = tiny.run_tiny(workload, monkeypatch, trace=True)
    for name in NEW[workload]:
        assert res["metrics"][name]["value"] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    assert not [m for m in res["metrics"] if m.startswith("syncs_per_step")]
    listed = {m["name"] for m in harness.metrics_of(workload, True)}
    assert set(NEW[workload]) <= listed


def test_a_program_without_spans_leaves_the_metrics_out(monkeypatch):
    import multimodal_baby_tpu_torch.train as train
    monkeypatch.setattr(train, "profiler", types.SimpleNamespace())
    res = tiny.run_tiny("resnext_embed_b256", monkeypatch, trace=True)
    assert "host_ms.embed" not in res["metrics"]
    assert "trunk_ms.embed" in res["metrics"]
