#!/usr/bin/env python3
"""Two checkouts of the port, in turns, on the published recipe's kernels.

Times K1 (each ResNeXt-50 block shape of ``chip_smoke.BLOCKS_224``), K2
(``Q_BLOCKS_224``), the stage kernel (``STAGES_224``: K3a int8 and bf16,
K3b) and the published recipe's trunk forward and train step at B = 128,
each checkout in its own process, in the order parent, change, change,
parent, so that a change to code the published path shares (the 1x1
tiles' producers in ``csrc/conv_gemm.cuh`` and ``csrc/conv_gemm_s8.cuh``)
is read against its parent on one card. Each
process then runs every one of those kernels ``--launches`` times, with a
sync after each launch, under a watchdog: a launch that does not finish
within ``--watch`` seconds dumps the Python stacks and ends the process
(reported as a stall). Times are CUDA events (``chip_smoke.time_ms``, 20
calls after warm-up; stages 10) and the host clock over
``chip_smoke.TIMED_STEPS`` train steps (``chip_smoke.time_steps``).

The parent is a checkout unpacked beside this one (``git archive``); the
script copies itself into it and builds both checkouts' kernels at once
before the first turn. Each process's output goes to ``--log-dir``. Needs
an NVIDIA GPU and the CUDA toolkit:

    python3 scripts/ab_conv_producer.py --parent DIR [--launches 300]
        [--watch 60] [--log-dir build/ab_conv_producer]
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "AB_RESULT "


# ------------------------------------------------------------- one process

def measure(launches: int, watch: float) -> dict:
    """This checkout's times (ms) and its watchdog loops' launch counts."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as C

    faulthandler.dump_traceback_later(600, exit=True)  # the timed part
    res: dict = {}
    gen = torch.Generator().manual_seed(19)
    work = []  # (what, kernel) for the watchdog loops
    for name, H, cin, width, cout, s, ds, count in C.BLOCKS_224:
        x, fw = C.random_block(gen, H, cin, width, cout, s, ds, C.BATCH)
        C.check(f"K1 {name}", C.fused_bottleneck(x, fw, stride=s),
                C.bottleneck_reference(x, fw, stride=s))
        fn = (lambda x=x, fw=fw, s=s: C.fused_bottleneck(x, fw, stride=s))
        res[f"K1 {name}"] = C.time_ms(fn, 20)
        res["K1 16 blocks"] = res.get("K1 16 blocks", 0.0) + count * res[
            f"K1 {name}"]
        work.append((f"K1 {name}", fn))
    for name, H, cin, width, cout, s, ds in C.Q_BLOCKS_224:
        fw = C.random_q_block(gen, cin, width, cout, ds)
        x = C.random_codes(gen, C.BATCH, H, cin)
        C.check_codes(f"K2 {name}", C.fused_bottleneck(x, fw, stride=s),
                      C.bottleneck_reference_q(x, fw, stride=s))
        fn = (lambda x=x, fw=fw, s=s: C.fused_bottleneck(x, fw, stride=s))
        res[f"K2 {name}"] = C.time_ms(fn, 20)
        work.append((f"K2 {name}", fn))
    for name, H, cin, width, cout, strides, int8, band in C.STAGES_224:
        x, fws = C.stage_inputs(gen, H, cin, width, cout, strides, int8,
                                C.BATCH)
        what = (f"K3{'a' if band is None else 'b'} "
                f"{'int8' if int8 else 'bf16'} {name}")
        fn = (lambda x=x, fws=fws, st=strides, b=band:
              C.fused_stage(x, fws, st) if b is None
              else C.fused_stage_banded(x, fws, st, b))
        got, want = fn(), C.stage_reference(x, fws, strides)
        (C.check_codes if int8 else C.check)(what, got, want)
        res[what] = C.time_ms(fn, 10)
        work.append((what, fn))

    cfg, model, batch = C.build_resnext_slice(C.MIXED, None)
    C.calibrate_trunk(model, batch)
    state, train_step, _ = C.drive(model, cfg, batch, [])
    trunk = model.vision_encoder.model
    with torch.no_grad():
        img = C.augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        res["published trunk forward"] = C.time_ms(
            lambda: trunk.forward_folded(img), 10)
    res["published train step"] = 1e3 * C.time_steps(
        state, train_step, batch, "published")
    faulthandler.cancel_dump_traceback_later()

    for what, fn in work:  # every launch synced, each under the watchdog
        print(f"watch {what}: {launches} launches", flush=True)
        for _ in range(launches):
            faulthandler.dump_traceback_later(watch, exit=True)
            fn()
            torch.cuda.synchronize()
        faulthandler.cancel_dump_traceback_later()
        res[f"watch {what}"] = launches
    return res


# ------------------------------------------------------------------ turns

def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def turns(parent: Path, launches: int, watch: float, log_dir: Path) -> int:
    trees = {"parent": parent.resolve(), "change": ROOT}
    script = trees["parent"] / "scripts" / Path(__file__).name
    script.parent.mkdir(exist_ok=True)
    shutil.copy(__file__, script)
    log_dir.mkdir(parents=True, exist_ok=True)
    print(smi(), flush=True)

    t0 = time.perf_counter()
    builds = {k: subprocess.Popen(
        [sys.executable, "-c", "from multimodal_baby_tpu_torch.ops import "
         "_build; _build.build()"], cwd=tree) for k, tree in trees.items()}
    for k, proc in builds.items():
        if proc.wait():
            print(f"{k}: the kernels did not build", flush=True)
            return 1
    print(f"both checkouts built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    order = ["parent", "change", "change", "parent"]
    runs: dict = {k: [] for k in trees}
    ok = True
    for i, k in enumerate(order):
        t0 = time.perf_counter()
        cmd = [sys.executable, str(trees[k] / "scripts" / Path(__file__).name),
               "--measure", "--launches", str(launches), "--watch",
               str(watch)]
        proc = subprocess.run(cmd, cwd=trees[k], capture_output=True,
                              text=True)
        (log_dir / f"{i}_{k}.log").write_text(proc.stdout + proc.stderr)
        got = [ln[len(TAG):] for ln in proc.stdout.splitlines()
               if ln.startswith(TAG)]
        print(f"turn {i} {k}: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode or not got:
            ok = False
            print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
            continue
        runs[k].append(json.loads(got[-1]))

    keys = [key for r in runs["change"] + runs["parent"] for key in r]
    keys = list(dict.fromkeys(keys))
    print("metric | parent turns | change turns | parent mean | change "
          "mean | change / parent", flush=True)
    summary = {}
    for key in keys:
        p = [r[key] for r in runs["parent"] if key in r]
        c = [r[key] for r in runs["change"] if key in r]
        if key.startswith("watch "):
            print(f"{key} | {p} | {c} | launches clean", flush=True)
            continue
        pm = statistics.mean(p) if p else float("nan")
        cm = statistics.mean(c) if c else float("nan")
        summary[key] = (pm, cm)
        print(f"{key} | {' / '.join(f'{v:.4f}' for v in p)} | "
              f"{' / '.join(f'{v:.4f}' for v in c)} | {pm:.4f} | {cm:.4f} | "
              f"{cm / pm:.4f}", flush=True)
    (log_dir / "summary.json").write_text(json.dumps(
        {"device": smi(), "runs": runs, "means": summary}, indent=1))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the parent checkout to time against")
    ap.add_argument("--launches", type=int, default=300,
                    help="watchdog launches of each kernel a process")
    ap.add_argument("--watch", type=float, default=60.0,
                    help="seconds a watched launch may take")
    ap.add_argument("--log-dir", type=Path,
                    default=ROOT / "build" / "ab_conv_producer")
    ap.add_argument("--measure", action="store_true",
                    help="time this checkout alone (one turn)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_conv_producer: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(TAG + json.dumps(measure(args.launches, args.watch)),
              flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    return turns(args.parent, args.launches, args.watch, args.log_dir)


if __name__ == "__main__":
    sys.exit(main())
