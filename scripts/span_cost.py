#!/usr/bin/env python3
"""What the program's spans cost while a profiler session records: a
benchmark train cell's closed loop (``benchmark/loops/train.py``'s calls
on its seeded weights and pool) timed over whole windows of ``--seconds``,
with no profiler, then under ``torch.profiler`` (CPU and CUDA activity)
with the spans on and off in turns (on, off, off, on), each window
after a full garbage collection. Spans are turned off by hiding the
profiler's flag from ``train/profiler.py``; the profiler records the same
either way. One JSON line: each window's steps, seconds and pairs/s, and
the spans' summary of the last window that recorded them. Run from the
root of a checkout on a machine with a CUDA card:

    python3 scripts/span_cost.py --workload vit_train_b512 --seed 7 \
        [--seconds 40]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args()

    from benchmark import harness, program, run
    run._setup_env()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.reference import cvcl as ref
    from benchmark.reference.weights import make_weights
    from multimodal_baby_tpu_torch.train import profiler
    from multimodal_baby_tpu_torch.train.step import (
        HostStaging, device_batch, init_train_state, make_train_step)

    c = harness.cell(args.workload)
    cfg, tr = harness.config(c["config"]), harness.traffic(c["traffic"])
    if tr["loop"] != "train":
        raise SystemExit(f"{args.workload} is not a train cell")
    exp = program.experiment(cfg, tr, args.seed)
    weights = make_weights(ref.model_spec(cfg),
                           harness.sub_seed(args.seed, "weights"), "cuda")
    model = program.build_model(exp, weights, "cuda")
    del weights
    state = init_train_state(model, exp)
    train_step = make_train_step(model, exp)
    staging = HostStaging()
    pool = program.train_pool(cfg, tr, args.seed, "cuda")
    i = 0

    def step():
        nonlocal i
        out = train_step(state, device_batch(pool[i % len(pool)], "cuda",
                                             staging))
        i += 1
        return out

    for _ in range(tr["check_steps"] + tr["warmup_steps"]):
        step()
    torch.cuda.synchronize()

    def window():
        # the last session's parsed events are garbage now: collected
        # here, not in the middle of the next window
        gc.collect()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            step()
            n += 1
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return {"steps": n, "window_s": s, "pairs_per_s": n * tr["batch"] / s}

    flag = profiler._autograd_profiler
    off = types.SimpleNamespace(_is_profiler_enabled=False)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "power_limit_w": run.power_limit_w(), "windows": []}
    out["windows"].append(dict(window(), profiler=False, spans=False))
    for spans in (True, False, False, True):
        profiler._autograd_profiler = flag if spans else off
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                w = window()
        finally:
            profiler._autograd_profiler = flag
        out["windows"].append(dict(w, profiler=True, spans=spans))
        if spans:
            out["spans"] = profiler.SPANS.summary("mmb/train_step")
            out["spans_kept"] = len(profiler.SPANS.spans)
        print(json.dumps(out["windows"][-1]), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
