"""Prediction-JSON aggregation -> the Science-paper summary CSVs: a copy
of ``multimodal_baby_tpu/analysis/summaries.py`` (the same columns and
file globs), kept so that the port imports nothing of the JAX package.

Output-contract parity with analysis_cvcl/clean.py (352 LoC): that script
gathers `eval.py` predictions JSONs into four row-level summary CSVs under
results/summary/ —

  saycam-bounds-summary.csv      (clean.py:56-155: CVCL + shuffled + CLIP
                                  + linear-probe bounds, `filtered` col)
  saycam-ablations.csv           (clean.py:157-261: embedding/lstm/
                                  finetune-random/frozen-random/single-
                                  frame configs)
  object-categories.csv          (clean.py:263-352: contrastive/shuffled/
                                  clip/linear-probe, `split` col)
  saycam-transformer-summary.csv (clean_transformer.py — same schema,
                                  transformer configs)

Each CSV is the concatenation of per-trial rows with clean.py's added
columns: ``target_category`` (= categories[0]), ``config``, and
``filtered`` / ``split``. The column schema below matches the shipped
artifact (results/summary/saycam-transformer-summary.csv header)
verbatim, so downstream notebooks/R figures consume our files unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

# exact column order of the shipped summary CSVs (clean.py output;
# verified against results/summary/saycam-transformer-summary.csv)
SUMMARY_COLUMNS = [
    "checkpoint", "model", "seed", "shuffle_utterances", "augment_frames",
    "multiple_frames", "cnn", "eval_type", "eval_dataset", "stage",
    "trial_idx", "categories", "logits", "pred", "correct",
    "target_category", "config",
]


def load_predictions(paths: Union[str, Iterable]) -> "pandas.DataFrame":
    """Tidy per-trial DataFrame from predictions JSON(s); categories and
    logits kept as Python lists (clean.py reads them the same way)."""
    import pandas as pd

    if isinstance(paths, (str, Path)):
        import glob as _glob
        pattern = str(paths)
        if any(ch in pattern for ch in "*?["):
            paths = [Path(p) for p in sorted(_glob.glob(pattern))]
        else:
            paths = [Path(pattern)]
    rows: List[dict] = []
    for p in paths:
        with open(p) as f:
            payload = json.load(f)
        data = payload["data"] if isinstance(payload, dict) else payload
        for r in data:
            row = dict(r)
            row["source_file"] = str(p)
            rows.append(row)
    return pd.DataFrame(rows)


def gather_results(groups: Sequence[dict]) -> "pandas.DataFrame":
    """clean.py's core loop: concat prediction files per config group.

    Each group: ``{"paths": [...json...], "config": str, **extra_cols}``
    — extra cols (e.g. ``filtered``, ``split``, ``seed``) are broadcast
    onto every row of that group, exactly like clean.py's per-list
    annotations.
    """
    import pandas as pd

    frames = []
    for group in groups:
        group = dict(group)
        paths = group.pop("paths")
        config = group.pop("config")
        for p in ([paths] if isinstance(paths, (str, Path)) else paths):
            df = load_predictions(p).drop(columns=["source_file"])
            if df.empty:
                continue
            df["target_category"] = df["categories"].str[0]
            df["config"] = config
            for col, value in group.items():
                df[col] = value
            frames.append(df)
    if not frames:
        return pd.DataFrame(columns=SUMMARY_COLUMNS)
    out = pd.concat(frames, ignore_index=True)
    # reference column order first, any extras (filtered/split/...) after
    cols = [c for c in SUMMARY_COLUMNS if c in out.columns]
    cols += [c for c in out.columns if c not in cols]
    return out[cols]


def write_summary_csv(groups: Sequence[dict], out_csv,
                      index: bool = False) -> "pandas.DataFrame":
    """Gather + write one of the four summary artifacts."""
    df = gather_results(groups)
    Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out_csv, index=index)
    return df


def _seeded(pattern: str, seeds: Sequence[int]) -> List[str]:
    return [pattern.format(seed=s) for s in seeds]


def write_bounds_summary(results_dir, out_csv=None,
                         seeds: Sequence[int] = (0, 1, 2)
                         ) -> "pandas.DataFrame":
    """saycam-bounds-summary.csv (clean.py:56-155): CVCL embedding (raw +
    manually-filtered trials), shuffled, CLIP baseline, and the
    linear-probe bounds at 100/10/1% of the data."""
    d = Path(results_dir)
    groups = [
        {"paths": _seeded(str(
            d / "saycam/embedding_frozen_pretrained_seed_{seed}_image_saycam_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_embedding", "filtered": False},
        {"paths": _seeded(str(
            d / "saycam/embedding_frozen_pretrained_seed_{seed}_image_saycam_test_eval_manual_filtered_predictions.json"),
            seeds),
         "config": "contrastive_embedding", "filtered": True},
        {"paths": _seeded(str(
            d / "saycam/shuffle_embedding_frozen_pretrained_seed_{seed}_image_saycam_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_shuffled"},
        {"paths": _seeded(str(
            d / "saycam/embedding_linear_probe_seed_{seed}_image_saycam_eval_predictions.json"),
            seeds),
         "config": "supervised_linear_probe_all"},
        {"paths": _seeded(str(
            d / "saycam/embedding_linear_probe_10_percent_seed_{seed}_image_saycam_eval_predictions.json"),
            seeds),
         "config": "supervised_linear_probe_10_percent"},
        {"paths": _seeded(str(
            d / "saycam/embedding_linear_probe_1_percent_seed_{seed}_image_saycam_eval_predictions.json"),
            seeds),
         "config": "supervised_linear_probe_1_percent"},
        {"paths": [str(d / "saycam/clip_image_saycam_test_eval_predictions.json")],
         "config": "clip (vit-l/14)", "seed": 0},
    ]
    groups = _existing(groups)
    out_csv = out_csv or d / "summary/saycam-bounds-summary.csv"
    return write_summary_csv(groups, out_csv, index=True)


def write_ablations_summary(results_dir, out_csv=None,
                            seeds: Sequence[int] = (0, 1, 2)
                            ) -> "pandas.DataFrame":
    """saycam-ablations.csv (clean.py:157-261)."""
    d = Path(results_dir)
    patterns = [
        ("embedding_frozen_pretrained", "contrastive_embedding"),
        ("lstm_frozen_pretrained", "contrastive_lstm"),
        ("embedding_finetune_random_init",
         "contrastive_embedding_finetune_random_init"),
        ("embedding_frozen_random_init",
         "contrastive_embedding_frozen_random_init"),
        ("embedding_frozen_pretrained_multiple_frames_False",
         "contrastive_embedding_single_frame"),
    ]
    groups = [
        {"paths": _seeded(str(
            d / f"saycam/{stem}_seed_{{seed}}_image_saycam_test_eval_predictions.json"),
            seeds),
         "config": config}
        for stem, config in patterns]
    groups = _existing(groups)
    out_csv = out_csv or d / "summary/saycam-ablations.csv"
    return write_summary_csv(groups, out_csv, index=False)


def write_object_categories_summary(results_dir, out_csv=None,
                                    seeds: Sequence[int] = (0, 1, 2)
                                    ) -> "pandas.DataFrame":
    """object-categories.csv (clean.py:263-352), incl. the first/last
    half-split linear probes."""
    d = Path(results_dir)
    groups = [
        {"paths": _seeded(str(
            d / "object_categories/embedding_frozen_pretrained_seed_{seed}_image_object_categories_test_eval_predictions.json"),
            seeds),
         "config": "contrastive", "split": None},
        {"paths": _seeded(str(
            d / "object_categories/embedding_frozen_random_init_seed_{seed}_image_object_categories_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_frozen_random_init", "split": None},
        {"paths": _seeded(str(
            d / "object_categories/shuffle_embedding_frozen_pretrained_seed_{seed}_image_object_categories_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_shuffled", "split": None},
        {"paths": [str(
            d / "object_categories/clip_image_object_categories_test_eval_predictions.json")],
         "config": "clip", "split": None},
    ] + [
        {"paths": [str(
            d / f"object_categories/embedding_object_categories_linear_probe_seed_{s}_split_{split}_image_object_categories_eval_predictions.json")],
         "config": "linear_probe"}
        for s in seeds for split in ("first", "last")
    ]
    groups = _existing(groups)
    out_csv = out_csv or d / "summary/object-categories.csv"
    return write_summary_csv(groups, out_csv, index=True)


def write_transformer_summary(results_dir, out_csv=None,
                              seeds: Sequence[int] = (0, 1, 2)
                              ) -> "pandas.DataFrame":
    """saycam-transformer-summary.csv (clean_transformer.py): the
    CVCL-transformer variant's row-level summary, plus its
    object-categories counterpart when present."""
    d = Path(results_dir)
    groups = _existing([
        {"paths": _seeded(str(
            d / "saycam/transformer_frozen_pretrained_seed_{seed}_image_saycam_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_transformer_embedding", "filtered": False},
    ])
    out_csv = out_csv or d / "summary/saycam-transformer-summary.csv"
    df = write_summary_csv(groups, out_csv, index=True)

    oc_groups = _existing([
        {"paths": _seeded(str(
            d / "object_categories/transformer_frozen_pretrained_seed_{seed}_image_object_categories_test_eval_predictions.json"),
            seeds),
         "config": "contrastive_transformer_embedding", "split": None},
    ])
    if oc_groups:
        write_summary_csv(
            oc_groups, d / "summary/object-categories-transformer.csv",
            index=True)
    return df


def _existing(groups: Sequence[dict]) -> List[dict]:
    """Keep the groups whose prediction files exist (the reference script
    hard-fails on missing files; we degrade to the available subset so the
    artifact can be built incrementally)."""
    kept = []
    for g in groups:
        paths = [p for p in g["paths"] if Path(p).exists()]
        if paths:
            kept.append(dict(g, paths=paths))
    return kept


# ---------------------------------------------------------------------------
# accuracy roll-ups (kept from round 1: handy tables on top of the
# row-level contract)
# ---------------------------------------------------------------------------

def summarize(df: "pandas.DataFrame",
              group_keys: Optional[List[str]] = None) -> "pandas.DataFrame":
    """Accuracy per (checkpoint, seed, stage, target category)."""
    import pandas as pd

    df = df.copy()
    if "target_category" not in df.columns:
        df["target_category"] = df["categories"].str[0]
    keys = group_keys or [k for k in
                          ("checkpoint", "seed", "stage", "eval_type")
                          if k in df.columns]
    per_class = (df.groupby(keys + ["target_category"])["correct"]
                 .agg(["mean", "count"]).reset_index()
                 .rename(columns={"mean": "accuracy", "count": "n_trials"}))
    total = (df.groupby(keys)["correct"].agg(["mean", "count"])
             .reset_index()
             .rename(columns={"mean": "accuracy", "count": "n_trials"}))
    total["target_category"] = "TOTAL"
    return pd.concat([per_class, total], ignore_index=True)


def write_summary(pred_glob: str, out_csv) -> "pandas.DataFrame":
    df = load_predictions(pred_glob)
    summary = summarize(df)
    Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
    summary.to_csv(out_csv, index=False)
    return summary
