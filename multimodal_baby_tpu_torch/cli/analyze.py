"""Analysis-artifact writers as a CLI (counterpart of
``multimodal_baby_tpu/cli/analyze.py``; reference: analysis_cvcl/
clean.py, alignment.py, duplicates.py, descriptives.py and figures.R),
with the same file contracts:

    python -m multimodal_baby_tpu_torch.cli.analyze summaries \\
        --results_dir results                 # the three clean.py CSVs
    python -m multimodal_baby_tpu_torch.cli.analyze alignment \\
        --checkpoint <ckpt> --eval_frames_dir data/eval_filtered/test \\
        --out_dir results/alignment --seed 0 [--device cuda|cpu]
    python -m multimodal_baby_tpu_torch.cli.analyze duplicates \\
        --checkpoint <ckpt> --data_dir data --out_dir results/duplicates \\
        [--device cuda|cpu]
    python -m multimodal_baby_tpu_torch.cli.analyze descriptives \\
        --data_dir data --out_csv results/descriptives.csv
    python -m multimodal_baby_tpu_torch.cli.analyze figures \\
        --summary_csv results/summary/saycam-bounds-summary.csv \\
        --out_dir results/figures [--metadata data/train.json]

``alignment`` and ``duplicates`` load the checkpoint with ``load_model``
on ``--device`` (the card by default), in the kernel configuration of the
kernel flags (``cli/args.py::add_kernel_args``), and run the image
embeddings through the trunk's kernels there. ``summaries`` and
``descriptives`` run on the host with pandas; ``figures`` needs
matplotlib.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_baby_tpu_torch.cli.args import (
    add_kernel_args, kernel_config_from_args)


def _summaries(args):
    from multimodal_baby_tpu_torch.analysis.summaries import (
        write_ablations_summary, write_bounds_summary,
        write_object_categories_summary)

    d = Path(args.results_dir)
    out = {}
    for name, fn in (("saycam-bounds-summary", write_bounds_summary),
                     ("saycam-ablations", write_ablations_summary),
                     ("object-categories",
                      write_object_categories_summary)):
        out[name] = fn(d)
        print(f"{name}.csv: {len(out[name])} rows")
    return out


def _alignment(args):
    from multimodal_baby_tpu_torch.analysis.embeddings import (
        category_feature_sets, write_alignment_csvs,
        write_joint_embeddings_with_eval_sims)
    from multimodal_baby_tpu_torch.api.model import load_model

    model, _ = load_model(args.checkpoint, device=args.device,
                          kernels=kernel_config_from_args(args))
    feats = category_feature_sets(
        model.model, args.eval_frames_dir, model.vocab, seed=args.seed)
    out = Path(args.out_dir)
    _, _, (r, p) = write_alignment_csvs(
        feats["mean_image_features"], feats["text_features"],
        feats["categories"], out, model=args.model_name, seed=args.seed)
    print(f"alignment pearson r={r:.4f} (p={p:.2e})")
    write_joint_embeddings_with_eval_sims(
        feats["all_image_features"], feats["mean_image_features"],
        feats["text_features"], feats["image_categories"],
        feats["image_filenames"], feats["categories"],
        out / (f"{args.model_name}_joint_embeddings_with_eval_sims_"
               f"seed_{args.seed}.csv"),
        seed=args.seed)
    print(f"wrote alignment CSVs to {out}")
    return feats


def frame_loader(frames_dir):
    """path -> [224, 224, 3] uint8 frame; a relative path that does not
    exist is taken relative to ``frames_dir``."""
    from PIL import Image

    def load(path):
        p = Path(path)
        if not p.is_absolute() and not p.exists():
            p = Path(frames_dir) / p
        return np.asarray(Image.open(p).convert("RGB").resize((224, 224)))
    return load


def frame_embedder(model, load, batch_size: int = 64):
    """paths -> [N, E] image embeddings of the frames ``load`` reads, in
    chunks of ``batch_size`` through ``model.encode_image``."""
    from multimodal_baby_tpu_torch.evaluation.linear_probe import (
        extract_features)

    def embed(paths):
        return extract_features(model, np.stack([load(p) for p in paths]),
                                batch_size)
    return embed


def leak_audit_metadata(data_dir, eval_metadata):
    """(train metadata of every split present, eval trial metadata)."""
    data_dir = Path(data_dir)
    train_md = []
    for split in ("train", "val", "test"):
        p = data_dir / f"{split}.json"
        if p.exists():
            train_md += json.loads(p.read_text())["data"]
    eval_md = json.loads((data_dir / eval_metadata).read_text())["data"]
    return train_md, eval_md


def _duplicates(args):
    from multimodal_baby_tpu_torch.analysis.duplicates import run_leak_audit
    from multimodal_baby_tpu_torch.api.model import load_model

    model, _ = load_model(args.checkpoint, device=args.device,
                          kernels=kernel_config_from_args(args))
    train_md, eval_md = leak_audit_metadata(args.data_dir,
                                            args.eval_metadata)
    load = frame_loader(Path(args.data_dir) / "train_5fps")
    report = run_leak_audit(train_md, eval_md,
                            frame_embedder(model.model, load), args.out_dir,
                            load_image=load)
    print(json.dumps(report["proportions_over"], indent=2))
    return report


def _descriptives(args):
    from multimodal_baby_tpu_torch.analysis.descriptives import (
        dataset_descriptives, date_descriptives, load_split_frame)

    df = load_split_frame(args.data_dir)
    vocab_path = Path(args.data_dir) / "vocab.json"
    vocab_size = len(json.loads(vocab_path.read_text())) \
        if vocab_path.exists() else None
    table = dataset_descriptives(df, vocab_size=vocab_size)
    print(table.to_string(index=False))
    if args.out_csv:
        Path(args.out_csv).parent.mkdir(parents=True, exist_ok=True)
        table.to_csv(args.out_csv, index=False)
    try:
        print(json.dumps(date_descriptives(df), indent=2))
    except (KeyError, IndexError, TypeError, ValueError):
        pass  # frame filenames without embedded dates
    return table


def _figures(args):
    from multimodal_baby_tpu_torch.analysis.figures import render_all
    utterances = None
    if args.metadata:
        with open(args.metadata) as f:
            payload = json.load(f)
        data = payload.get("data", payload)
        utterances = [r.get("utterance", "") for r in data]
    written = render_all(args.summary_csv, args.out_dir,
                         utterances=utterances)
    for p in written:
        print(p)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summaries")
    p.add_argument("--results_dir", default="results")
    p.set_defaults(fn=_summaries)

    p = sub.add_parser("alignment")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--out_dir", default="results/alignment")
    p.add_argument("--model_name", default="cvc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    add_kernel_args(p)
    p.set_defaults(fn=_alignment)

    p = sub.add_parser("duplicates")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--eval_metadata", default="eval_filtered_test.json")
    p.add_argument("--out_dir", default="results/duplicates")
    p.add_argument("--device", default="cuda")
    add_kernel_args(p)
    p.set_defaults(fn=_duplicates)

    p = sub.add_parser("descriptives")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--out_csv", default=None)
    p.set_defaults(fn=_descriptives)

    p = sub.add_parser(
        "figures",
        help="paper figures from a summary CSV (figures.R equivalent)")
    p.add_argument("--summary_csv", required=True)
    p.add_argument("--out_dir", default="results/figures")
    p.add_argument("--metadata", default=None,
                   help="train metadata JSON for the corpus panel")
    p.set_defaults(fn=_figures)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
