"""The program's own spans of a run's traced block
(``multimodal_baby_tpu_torch/train/profiler.py``: ``span``, ``wait``,
``SPANS``), summed per step: per train step (``mmb/train_step``) in a
train cell, per chunk (``mmb/embed_chunk``, one ``extract_features`` call
of the embed mix) in the embed cell. This is the only module here that
reads the program's store; where the program has none (a commit before
the spans) or the block kept no such root, every reader gets None and
its metric is left out.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 10]

makes one traced run of the cell and prints the block's summary beside
the run's metrics: device ms by span, self ms, host ms, waits and
synchronizing calls a step, and ``mmb/trunk`` against ``trunk_ms``."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOTS = {"train": "mmb/train_step", "embed": "mmb/embed_chunk"}


def summary(facts: dict) -> Optional[dict]:
    """``SPANS.summary`` of the traced block per root of the run's kind,
    or None."""
    try:
        from multimodal_baby_tpu_torch.train import profiler
    except ImportError:
        return None
    store = getattr(profiler, "SPANS", None)
    root = ROOTS.get(facts.get("kind"))
    if store is None or root is None:
        return None
    return store.summary(root)


def layer_ms(facts: dict, name: str) -> Optional[float]:
    """Device ms a step in the spans named ``name`` (host ms on the CPU)."""
    s = summary(facts)
    if s is None:
        return None
    return s["device_ms"].get(name)


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import harness, run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run._setup_env()
    res = run.run_cell(args.workload, args.seed, args.seconds, True,
                       args.device, time.perf_counter())
    kind = harness.traffic(harness.cell(args.workload)["traffic"])["loop"]
    s = summary({"kind": kind})
    out = {"workload": args.workload, "seed": args.seed,
           "correct": res["correct"], "device": res["device"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "spans": s}
    trunk = res["metrics"].get(f"trunk_ms.{kind}")
    if s and trunk and "mmb/trunk" in s["device_ms"]:
        root = ROOTS[kind]
        out["trunk_span_over_hooks"] = s["device_ms"]["mmb/trunk"] / trunk[
            "value"]
        out["root_self_share"] = (s["self_ms"][root]
                                  / s["device_ms"][root])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
