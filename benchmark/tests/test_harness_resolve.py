"""Every configuration, traffic mix, loop, counter, limit and metric
reader resolves by name, and a new traffic file in a copy of the
benchmark is found without editing any file."""

import json
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.reference import cvcl as ref


def test_everything_resolves_by_name():
    b = harness.spec()
    for c in b["configs"]:
        cfg = harness.config(c["name"])
        assert (harness.ROOT / c["file"]).is_file()
        harness.load_module("counters", cfg["architecture"])
        harness.load_module("counters", f"text_{cfg['text_encoder']}")
        assert ref.model_spec(cfg)
    for w in b["workloads"]:
        tr = harness.traffic(w["traffic"])
        harness.load_module("loops", tr["loop"])
        assert harness.limits(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_dotted_metric_names_read_by_their_stem():
    assert harness.metric_reader("trunk_ms.train").__file__.endswith(
        "trunk_ms.py")


def test_a_new_traffic_file_is_found_without_edits(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.SPEC, copy / "BENCHMARK.json")
    mix = dict(harness.traffic("train_b512"), batch=32)
    (copy / "benchmark" / "traffic" / "dummy_b32.json").write_text(
        json.dumps(mix))
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy", "config": "cvcl_resnext50",
                              "traffic": "dummy_b32", "chips": 1,
                              "why": "a test's cell"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from benchmark import harness; c = harness.cell('dummy'); "
            "t = harness.traffic(c['traffic']); "
            "print(t['batch'], harness.load_module('loops', "
            "t['loop']).__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy,
                         capture_output=True, text=True, check=True).stdout
    assert out.split() == ["32", "benchmark_loops_train"]


def test_a_new_trunk_reference_is_found_without_edits(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.SPEC, copy / "BENCHMARK.json")
    (copy / "benchmark" / "reference" / "dummy_trunk.py").write_text(
        "OUT_DIM = 8\nHEAD = 'proj'\n\n"
        "def spec(prefix, px=224):\n"
        "    return [(f'{prefix}w', (OUT_DIM, 3), ('normal', 1.0))]\n")
    cfg = dict(harness.config("cvcl_resnext50"), architecture="dummy_trunk")
    (copy / "benchmark" / "configs" / "dummy.json").write_text(
        json.dumps(cfg))
    code = ("from benchmark import harness; "
            "from benchmark.reference import cvcl; "
            "print(*[n for n, *_ in cvcl.model_spec(harness.config('dummy'))"
            "][:3])")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy,
                         capture_output=True, text=True, check=True).stdout
    assert out.split() == ["vision_encoder.model.w",
                           "vision_encoder.model.proj.weight",
                           "vision_encoder.model.proj.bias"]
