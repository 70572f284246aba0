#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``multimodal_baby_tpu_torch``:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
makes the weights and the inputs from the seed, warms up the cell's
shapes (set-up), measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints one JSON line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), each number compared beside its limit, the device.
Without the cards it needs it exits with 2 and prints no result; if a
module of JAX or of the JAX package is loaded once the window has
closed, it exits with 3 and prints no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout; the
# program's own nvcc build directory is <checkout>/build/cuda
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/nv_compute_cache"}


def _setup_env() -> None:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / sub)
    os.environ["USE_FLAX"] = "0"


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """The result line of one run, as a dict. ``overrides`` replaces parts
    of the run (tests: the traffic mix, the program's entry points)."""
    import torch
    from benchmark import harness
    from benchmark.trace import read_profile

    bench = harness.spec()
    c = harness.cell(workload, bench)
    overrides = overrides or {}
    ctx = {"config": harness.config(c["config"]),
           "traffic": overrides.pop("traffic", None)
           or harness.traffic(c["traffic"]),
           "seed": seed, "seconds": seconds, "trace": trace,
           "device": device, "t_start": t_start or time.perf_counter()}
    ctx.update(overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def profile(step, n):
        from torch.profiler import ProfilerActivity, profile as prof_
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with prof_(activities=acts) as prof:
            for _ in range(n):
                step()
            if cuda:
                torch.cuda.synchronize()
        return read_profile(prof, n)

    ctx["profile"] = profile
    loop = harness.load_module("loops", ctx["traffic"]["loop"])
    facts = loop.run(ctx)

    metrics = harness.read_metrics(harness.metrics_of(workload, trace, bench),
                                   facts)
    # the numbers the cell's limits name are compared; a reading without a
    # limit (one that no control or fault separates) is not
    checks = {}
    for name, limit in harness.limits(workload).items():
        if name not in facts["readings"]:
            raise KeyError(f"the run did not read {name!r}, which "
                           f"limits/{workload}.json names")
        checks[name] = {"value": facts["readings"][name], "limit": limit}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c["chips"],
           "memory_peak_bytes": facts["memory_peak_bytes"],
           "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": facts["steps"],
              "failed": int(facts["readings"].get(
                  "nonfinite_window_losses", 0)),
              "metrics": metrics, "device": dev}
    tr = facts.get("trace")
    if trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["setup_detail"] = dict(facts["setup_parts"],
                                  check_s=facts["check_s"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    import torch
    from benchmark import harness

    chips = harness.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
