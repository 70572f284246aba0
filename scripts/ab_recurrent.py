#!/usr/bin/env python3
"""Two checkouts of the port, in turns, on K9 and K4 and the paths that run
them.

Times K9 (``lstm_fused`` at (B, L, H) = (128, 25, 512) and (128, 64,
512), ``chip_smoke.lstm_case``'s inputs), K4's forward and backward
(``fused_infonce_forward``, ``fused_infonce_backward`` at B = 128 and 1024,
E = 512, unit-norm rows at T = 0.07), the LM recipe's train step at L = 64
(``chip_smoke.py`` phase 7c: the published trunk, ``fused_lstm=None``, so
K9 by the length rule) and the per-token pass's tokens/s (phase 11e:
``collect_token_data`` with ``fused_lstm=True``, 1,024 utterances of 2 to 23
words of the packaged vocabulary, batches of 64), each checkout in its own
process, in the order parent, change, change, parent, on one card. Kernel
times are CUDA events (``chip_smoke.time_ms``, 50 calls after warm-up), the
step the host clock over ``chip_smoke.TIMED_STEPS`` steps
(``chip_smoke.time_steps``), the pass the host clock around a synchronized
run.

The parent is a checkout unpacked beside this one (``git archive``); the
script copies itself into it and builds both checkouts' kernels at once
before the first turn. Each process's output goes to ``--log-dir``. Needs
an NVIDIA GPU and the CUDA toolkit:

    python3 scripts/ab_recurrent.py --parent DIR
        [--log-dir build/ab_recurrent]
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "AB_RESULT "
UTTERANCES = 1024


# ------------------------------------------------------------- one process

def measure() -> dict:
    """This checkout's times: ms, except tokens/s."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as C
    from multimodal_baby_tpu_torch.analysis.processing import (
        collect_token_data, sentence_batches)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res: dict = {}
    gen = torch.Generator().manual_seed(20)
    with torch.no_grad():
        for L in (C.MAX_LEN_UTTERANCE, C.LM_LEN):
            args = C.lstm_case(gen, C.BATCH, L, C.LSTM_H)[0]
            res[f"K9 (128, {L}, 512)"] = C.time_ms(
                lambda a=args: C.lstm_fused(*a), 50)
        nlt = torch.tensor(np.log(1 / 0.07), dtype=torch.float32,
                           device="cuda")
        g = torch.tensor(1.0, device="cuda")
        for B in C.INFONCE_BATCHES:
            x = torch.randn(2, B, C.INFONCE_E, generator=gen)
            img, txt = C.l2_normalize(x, dim=-1).cuda().unbind(0)
            _, lse_i, lse_t, _ = C.fused_infonce_forward(img, txt, nlt)
            res[f"K4 forward B={B}"] = C.time_ms(
                lambda: C.fused_infonce_forward(img, txt, nlt), 50)
            res[f"K4 backward B={B}"] = C.time_ms(
                lambda: C.fused_infonce_backward(img, txt, nlt, lse_i,
                                                 lse_t, g), 50)

    # phase 7c: the LM recipe at L = 64 on the calibrated published trunk
    _, model, _ = C.build_lstm_slice()
    cfg = C.recipe_cfg(0.0, 1.0)
    model.text_encoder.fused_lstm = None
    batch = C.make_lm_batch(np.random.RandomState(5), C.BATCH, C.LM_LEN)
    state, train_step, (k9,) = C.drive(model, cfg, batch,
                                       [(C.lstm_fused, "launches")])
    if k9 == 0:
        raise AssertionError("the LM step launched no K9")
    res["LM train step L=64"] = 1e3 * C.time_steps(state, train_step, batch,
                                                   "LM L=64")

    # phase 11e: the per-token pass with K9
    rng = np.random.RandomState(11)
    vocab = C.Vocab.load(C.PACKAGED_VOCAB)
    words = [w for w in vocab.word2idx if not w.startswith("<")]
    utts = [" ".join(rng.choice(words, rng.randint(2, 24)))
            for _ in range(UTTERANCES)]
    batches = list(sentence_batches(utts, vocab, batch_size=64,
                                    max_len=C.MAX_LEN_UTTERANCE))
    model.text_encoder.fused_lstm = True
    collect_token_data(model, batches[:1], vocab)  # warm-up
    before = C.lstm_fused.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = collect_token_data(model, batches, vocab)
    torch.cuda.synchronize()
    if C.lstm_fused.launches - before != len(batches):
        raise AssertionError("the per-token pass did not run K9 per batch")
    res["per-token pass tokens/s"] = len(out["token_id"]) / (
        time.perf_counter() - t0)
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


def turns(parent: Path, log_dir: Path) -> int:
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
               "--measure"]
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

    keys = list(dict.fromkeys(key for r in runs["change"] + runs["parent"]
                              for key in r))
    print("metric | parent turns | change turns | parent mean | change "
          "mean | change / parent", flush=True)
    summary = {}
    for key in keys:
        p = [r[key] for r in runs["parent"] if key in r]
        c = [r[key] for r in runs["change"] if key in r]
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
    ap.add_argument("--log-dir", type=Path,
                    default=ROOT / "build" / "ab_recurrent")
    ap.add_argument("--measure", action="store_true",
                    help="time this checkout alone (one turn)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_recurrent: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(TAG + json.dumps(measure()), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    return turns(args.parent, args.log_dir)


if __name__ == "__main__":
    sys.exit(main())
