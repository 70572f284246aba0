"""What every run shares: the cells of ``BENCHMARK.json``, and the files
found by name under this directory:

- ``configs/<config>.json``: the configuration as it runs (the recipe's
  experiment, the widths, the optimizer, the trunk's ``architecture``);
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the loop
  it names (``loops/<loop>.py``);
- ``metrics/<metric>.py``: one reader per metric, ``read(facts)`` ->
  a number or None; a name with a dot (``trunk_ms.train``) is read by
  ``metrics/trunk_ms.train.py`` where that exists, else by
  ``metrics/trunk_ms.py``;
- ``counters/<architecture>.py`` and ``counters/text_<encoder>.py``: the
  operations and bytes of a configuration's layers, from its shapes;
- ``reference/<architecture>.py`` and ``reference/text_<encoder>.py``: the
  plain reference of its trunk and of its text encoder;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.

A later cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores, 700 W
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_baby_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(SPEC)


def cell(name: str, bench: Optional[dict] = None) -> dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {SPEC.name}")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return load_json(BENCH / "limits" / f"{workload}.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module, by its path (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"benchmark_{kind}_{name.replace('.', '_')}"
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of metric ``name``: its own file, else the file of the
    name before its first dot."""
    if (BENCH / "metrics" / f"{name}.py").is_file():
        return load_module("metrics", name)
    return load_module("metrics", name.split(".")[0])


def metrics_of(workload: str, trace: bool, bench: Optional[dict] = None
               ) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    without trace, the per-layer ones with it, each where its
    ``workloads`` list names the cell (a metric without the list: every
    cell that reports the end-to-end metric it moves)."""
    bench = bench or spec()
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in e2e_names]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (weights, pool, generator) of ``seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank over every value."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: ``multimodal_baby_tpu_torch`` is
    the program, not the JAX package)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def read_metrics(metrics: List[dict], facts: dict) -> Dict[str, dict]:
    """Each metric's reader on the run's facts; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(facts)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
