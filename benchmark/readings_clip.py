#!/usr/bin/env python3
"""The readings that the CLIP cell's limits are set from (not run by the
benchmark's own runs; ``readings.py`` for the cells of ``loops/train.py``
and ``loops/embed.py``):

    python3 benchmark/readings_clip.py --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2] [--out <file>]

For each seed of ``--seeds``, a whole run of ``clip_l14_train_b256``
(``run.run_cell``, its window ``--seconds`` long) and the numbers its
check compared: the sound runs' readings. For each of
``--control-seeds``, at the cell's own sizes: the control (the reference
with its products in fp8) and the fault of half the batch left out, each
against the reference (``loops/clip_train.py::control_readings``). One
JSON line per reading, to ``--out`` and to standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, run  # noqa: E402

CELL = "clip_l14_train_b256"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    run._setup_env()
    from benchmark.loops import clip_train
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        res = run.run_cell(CELL, int(s), args.seconds, False, args.device, t)
        emit({"workload": CELL, "seed": int(s), "kind": "sound",
              "readings": {k: v["value"] for k, v in res["checks"].items()},
              "correct": res["correct"], "metrics": res["metrics"],
              "memory_peak_bytes": res["device"]["memory_peak_bytes"],
              "check_s": res["setup_detail"]["check_s"],
              "run_s": time.perf_counter() - t})
    c = harness.cell(CELL)
    cfg, tr = harness.config(c["config"]), harness.traffic(c["traffic"])
    for s in filter(None, args.control_seeds.split(",")):
        for what, r in clip_train.control_readings(cfg, tr, int(s),
                                                   args.device):
            emit({"workload": CELL, "seed": int(s), "kind": what,
                  "readings": r})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
