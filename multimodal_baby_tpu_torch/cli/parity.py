"""Accuracy-parity harness against the reference implementation
(counterpart of ``multimodal_baby_tpu/cli/parity.py``): the BASELINE.md
parity number (Labeled-S zero-shot within 0.5% absolute).

    python -m multimodal_baby_tpu_torch.cli.parity \
        --checkpoint <reference .ckpt> --data_dir data \
        --eval_metadata eval_filtered_test.json \
        --reference_predictions ref_preds.json --gate 0.005 \
        [--device cuda|cpu]

Steps: (a) load the reference Lightning checkpoint on ``--device`` (the
card by default, in the kernel configuration of the kernel flags,
``cli/args.py::add_kernel_args``), (b) run the forced-choice trials with
the reference's scoring semantics (eval.py:175-266: a softmax over
logits_per_text, target index 0), (c) write our predictions JSON, and
(d) when a reference predictions JSON or a reference per-trial summary
CSV (analysis_cvcl/clean.py schema) is given, diff per-category and
total accuracies against it and exit non-zero if |delta total| > gate.

Not ported: ``--published`` (it downloads the published checkpoint from
the Hugging Face hub); it refuses with a message.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, Tuple

from multimodal_baby_tpu_torch.cli.args import (
    add_kernel_args, kernel_config_from_args)


def accuracy_from_predictions(path) -> Tuple[Dict[str, float], float]:
    """Per-category + total accuracy from a predictions JSON
    (schema of eval.py:248-266 — ours and the reference's interchange)."""
    with open(path) as f:
        payload = json.load(f)
    rows = payload["data"] if isinstance(payload, dict) else payload
    correct: Dict[str, int] = defaultdict(int)
    total: Dict[str, int] = defaultdict(int)
    for r in rows:
        cat = r["categories"][0] if isinstance(r["categories"], list) \
            else str(r["categories"]).split(",")[0]
        total[cat] += 1
        correct[cat] += int(bool(r["correct"]))
    per_cat = {c: correct[c] / total[c] for c in sorted(total)}
    overall = sum(correct.values()) / max(1, sum(total.values()))
    return per_cat, overall


def accuracy_from_summary_csv(path, seed=None, stage="test"
                              ) -> Tuple[Dict[str, float], float]:
    """Per-category + total accuracy from a reference summary CSV
    (analysis_cvcl/clean.py output, e.g. the shipped
    results/summary/saycam-transformer-summary.csv: one row per trial
    with target_category/correct/seed/stage columns). seed=None averages
    across all seeds (the published 55.5% is the 3-seed mean)."""
    import csv

    correct: Dict[str, int] = defaultdict(int)
    total: Dict[str, int] = defaultdict(int)
    with open(path) as f:
        for row in csv.DictReader(f):
            if stage is not None and row.get("stage") != stage:
                continue
            if seed is not None and row.get("seed") != str(seed):
                continue
            cat = row["target_category"]
            total[cat] += 1
            correct[cat] += int(row["correct"].strip().lower() == "true")
    per_cat = {c: correct[c] / total[c] for c in sorted(total)}
    overall = sum(correct.values()) / max(1, sum(total.values()))
    return per_cat, overall


def compare(ours: Dict[str, float], ours_total: float,
            ref: Dict[str, float], ref_total: float,
            gate: float = 0.005) -> Tuple[bool, str]:
    lines = [f"{'category':<16s} {'ours':>8s} {'reference':>10s} "
             f"{'delta':>8s}"]
    for cat in sorted(set(ours) | set(ref)):
        o, r = ours.get(cat), ref.get(cat)
        if o is None or r is None:
            lines.append(f"{cat:<16s} {'-' if o is None else f'{o:8.3f}'}"
                         f" {'-' if r is None else f'{r:10.3f}'} missing")
            continue
        lines.append(f"{cat:<16s} {o:8.3f} {r:10.3f} {o - r:+8.3f}")
    delta = ours_total - ref_total
    lines.append(f"{'TOTAL':<16s} {ours_total:8.3f} {ref_total:10.3f} "
                 f"{delta:+8.3f}  (gate ±{gate})")
    ok = abs(delta) <= gate
    lines.append("PARITY OK" if ok else "PARITY FAIL")
    return ok, "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", default=None,
                        help="reference Lightning .ckpt")
    parser.add_argument("--published", action="store_true",
                        help="not ported: downloads the published CVCL "
                        "checkpoint from the Hugging Face hub")
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--eval_metadata", default="eval_filtered_test.json")
    parser.add_argument("--eval_type", default="image",
                        choices=["image", "text"])
    parser.add_argument("--use_kitty_label", action="store_true")
    parser.add_argument("--eval_include_sos_eos", action="store_true",
                        help="wrap the trial label in <sos>/<eos> like the "
                        "published recipes (runner_config/"
                        "saycam_contrastive.py)")
    parser.add_argument("--reference_predictions", default=None)
    parser.add_argument("--reference_summary", default=None,
                        help="reference per-trial summary CSV "
                        "(analysis_cvcl/clean.py schema) as the "
                        "reference side of the diff")
    parser.add_argument("--ref_seed", default=None,
                        help="restrict --reference_summary rows to one "
                        "seed (default: average over all seeds)")
    parser.add_argument("--ref_stage", default="test")
    parser.add_argument("--gate", type=float, default=0.005)
    parser.add_argument("--output", default=None,
                        help="where to write our predictions JSON")
    parser.add_argument("--device", default="cuda")
    add_kernel_args(parser)
    args = parser.parse_args(argv)

    if args.published:
        parser.error("--published is not ported: it downloads "
                     "wkvong/cvcl_s_dino_resnext50_embedding from the "
                     "Hugging Face hub; download the .ckpt and pass "
                     "--checkpoint")
    if not args.checkpoint:
        parser.error("--checkpoint is required")

    from multimodal_baby_tpu_torch.api.model import load_model
    from multimodal_baby_tpu_torch.data.datasets import (
        EvalTrialDataset, TextEvalTrialDataset, load_metadata)
    from multimodal_baby_tpu_torch.evaluation.forced_choice import (
        print_accuracy_table, run_forced_choice, save_predictions)

    model, _ = load_model(args.checkpoint, device=args.device,
                          kernels=kernel_config_from_args(args))
    trials = load_metadata(Path(args.data_dir) / args.eval_metadata)
    cls = (EvalTrialDataset if args.eval_type == "image"
           else TextEvalTrialDataset)
    dataset = cls(trials, model.vocab,
                  eval_include_sos_eos=args.eval_include_sos_eos)
    accs, records = run_forced_choice(
        model.model, dataset, args.eval_type,
        use_kitty_label=args.use_kitty_label, vocab=model.vocab)
    print_accuracy_table(accs)

    out = args.output or (Path("results") / "parity_predictions.json")
    save_predictions(records, out, extra_fields={
        "checkpoint": str(args.checkpoint),
        "eval_type": args.eval_type,
        "stage": Path(args.eval_metadata).stem.split("_")[-1]})
    print(f"wrote {out}")

    if not args.reference_predictions and not args.reference_summary:
        print("no --reference_predictions / --reference_summary given; "
              "parity diff skipped")
        return 0

    ours_cat, ours_total = accuracy_from_predictions(out)
    if args.reference_summary:
        ref_cat, ref_total = accuracy_from_summary_csv(
            args.reference_summary, seed=args.ref_seed,
            stage=args.ref_stage)
    else:
        ref_cat, ref_total = accuracy_from_predictions(
            args.reference_predictions)
    ok, report = compare(ours_cat, ours_total, ref_cat, ref_total,
                         args.gate)
    print(report)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
