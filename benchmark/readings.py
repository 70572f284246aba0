#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2] [--out <file>]

For each seed of ``--seeds``, a whole run of the cell (``run.run_cell``,
its window ``--seconds`` long) and the numbers its check compared: the
sound runs' readings. For each of ``--control-seeds``, at the cell's own
sizes: the control, the reference computed with its products in fp8 put
in the program's place; in train cells also the fault of half the batch
left out (the reference again, the loss's mean over the rest). One JSON
line per reading, to ``--out`` and to standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402


def control_readings(workload: str, seed: int, device: str,
                     cfg: dict | None = None, tr: dict | None = None
                     ) -> list:
    from benchmark import check, harness, program
    from benchmark.reference import cvcl as ref
    from benchmark.reference.quant import fp8
    from benchmark.reference.weights import make_weights
    c = harness.cell(workload)
    cfg = cfg or harness.config(c["config"])
    tr = tr or harness.traffic(c["traffic"])
    spec = ref.model_spec(cfg)
    out = []
    if tr["loop"] == "train":
        pool = program.train_pool(cfg, tr, seed, device)[:tr["check_steps"]]
        r = check.reference_train(cfg, spec, seed, pool, device)
        for what, kw in (("control_fp8", {"quant": fp8}),
                         ("fault_half_batch", {"half_batch": True})):
            p = check.reference_train(cfg, spec, seed, pool, device, **kw)
            out.append((what, check.train_gaps(*p[:4], *r[:4], r[4])))
    else:
        frames = program.frame_pool(tr, seed, device)[0]
        ref.set_precision()
        w = make_weights(spec, harness.sub_seed(seed, "weights"), device)
        f_r = ref.embed(cfg, w, frames, device)
        f_c = ref.embed(cfg, w, frames, device, fp8)
        out.append(("control_fp8",
                    {"embed_gap": check.embed_gap(f_c.cpu().numpy(), f_r)}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    run._setup_env()
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        res = run.run_cell(args.workload, int(s), args.seconds, False,
                           args.device, t)
        emit({"workload": args.workload, "seed": int(s), "kind": "sound",
              "readings": {k: v["value"] for k, v in res["checks"].items()},
              "correct": res["correct"], "metrics": res["metrics"],
              "memory_peak_bytes": res["device"]["memory_peak_bytes"],
              "check_s": res["setup_detail"]["check_s"],
              "run_s": time.perf_counter() - t})
    for s in filter(None, args.control_seeds.split(",")):
        for what, r in control_readings(args.workload, int(s), args.device):
            emit({"workload": args.workload, "seed": int(s), "kind": what,
                  "readings": r})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
