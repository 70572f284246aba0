"""Analysis-artifact writers as a CLI (counterpart of
``multimodal_baby_tpu/cli/analyze.py``; reference: analysis_cvcl/
alignment.py and duplicates.py), with the same file contracts:

    python -m multimodal_baby_tpu_torch.cli.analyze alignment \\
        --checkpoint <ckpt> --eval_frames_dir data/eval_filtered/test \\
        --out_dir results/alignment --seed 0 [--device cuda|cpu]
    python -m multimodal_baby_tpu_torch.cli.analyze duplicates \\
        --checkpoint <ckpt> --data_dir data --out_dir results/duplicates \\
        [--device cuda|cpu]

The checkpoint loads with ``load_model`` on ``--device`` (the card by
default); the image embeddings run through the trunk's kernel plan there.

Not ported: ``summaries``, ``descriptives`` and ``figures``, which read
and write the CSV contracts of the reference's result tables
(``analysis/summaries.py``, ``descriptives.py``, ``figures.py``,
``plotting.py``; ROADMAP Queue 1, item 7); each refuses with a message.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

_NOT_PORTED = ("is not ported: the CSV-contract modules (analysis/"
               "summaries.py, descriptives.py, figures.py, plotting.py) wait "
               "for ROADMAP Queue 1, item 7; run it from the JAX package "
               "(python -m multimodal_baby_tpu.cli.analyze {cmd} ...)")


def _alignment(args):
    from multimodal_baby_tpu_torch.analysis.embeddings import (
        category_feature_sets, write_alignment_csvs,
        write_joint_embeddings_with_eval_sims)
    from multimodal_baby_tpu_torch.api.model import load_model

    model, _ = load_model(args.checkpoint, device=args.device)
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

    model, _ = load_model(args.checkpoint, device=args.device)
    train_md, eval_md = leak_audit_metadata(args.data_dir,
                                            args.eval_metadata)
    load = frame_loader(Path(args.data_dir) / "train_5fps")
    report = run_leak_audit(train_md, eval_md,
                            frame_embedder(model.model, load), args.out_dir,
                            load_image=load)
    print(json.dumps(report["proportions_over"], indent=2))
    return report


def _not_ported(parser, cmd):
    def refuse(args):
        parser.error(f"{cmd} {_NOT_PORTED.format(cmd=cmd)}")
    return refuse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("alignment")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--eval_frames_dir", required=True)
    p.add_argument("--out_dir", default="results/alignment")
    p.add_argument("--model_name", default="cvc")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_alignment)

    p = sub.add_parser("duplicates")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--eval_metadata", default="eval_filtered_test.json")
    p.add_argument("--out_dir", default="results/duplicates")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_duplicates)

    for cmd in ("summaries", "descriptives", "figures"):
        p = sub.add_parser(cmd, help="not ported (ROADMAP Queue 1, item 7)")
        p.set_defaults(fn=_not_ported(parser, cmd))

    args, extra = parser.parse_known_args(argv)
    if args.cmd in ("alignment", "duplicates") and extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
