"""Corpus descriptive statistics: a copy of
``multimodal_baby_tpu/analysis/descriptives.py``, kept so that the port
imports nothing of the JAX package (reference: analysis_cvcl/
descriptives.py): utterance and token counts, length distributions,
vocabulary coverage, and the per-split and date tables."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List


def corpus_stats(utterances: Iterable[str]) -> Dict[str, float]:
    lengths: List[int] = []
    counter: Counter = Counter()
    for utt in utterances:
        toks = utt.split()
        lengths.append(len(toks))
        counter.update(toks)
    n_utts = len(lengths)
    n_tokens = sum(lengths)
    return {
        "n_utterances": n_utts,
        "n_tokens": n_tokens,
        "n_types": len(counter),
        "mean_utterance_length": n_tokens / max(1, n_utts),
        "max_utterance_length": max(lengths) if lengths else 0,
        "type_token_ratio": len(counter) / max(1, n_tokens),
        "top_tokens": counter.most_common(20),
    }


def length_distribution(utterances: Iterable[str]) -> Counter:
    c: Counter = Counter()
    for utt in utterances:
        c[len(utt.split())] += 1
    return c


def frequency_table(utterances: Iterable[str]) -> "pandas.DataFrame":
    import numpy as np
    import pandas as pd

    counter: Counter = Counter()
    for utt in utterances:
        counter.update(utt.split())
    df = pd.DataFrame(counter.most_common(), columns=["token", "count"])
    df["rank"] = np.arange(1, len(df) + 1)
    return df


# ---------------------------------------------------------------------------
# the reference's descriptives tables (analysis_cvcl/descriptives.py)
# ---------------------------------------------------------------------------

def load_split_frame(data_dir) -> "pandas.DataFrame":
    """train/val/test metadata JSONs -> one DataFrame with a `split`
    column (descriptives.py:23-46)."""
    import json
    from pathlib import Path

    import pandas as pd

    frames = []
    for split in ("train", "val", "test"):
        p = Path(data_dir) / f"{split}.json"
        if not p.exists():
            continue
        df = pd.DataFrame(json.loads(p.read_text())["data"])
        df["split"] = split
        frames.append(df)
    return pd.concat(frames, ignore_index=True)


def dataset_descriptives(saycam_df: "pandas.DataFrame",
                         vocab_size: int = None) -> "pandas.DataFrame":
    """Per-split corpus table (descriptives.py:53-105): utterances,
    tokens, frames, mean utterance length, mean frames/utterance, plus a
    TOTAL row. Returns a tidy DataFrame instead of prints."""
    import pandas as pd

    df = saycam_df.copy()
    df["split"] = pd.Categorical(df["split"],
                                 categories=["train", "val", "test"],
                                 ordered=True)
    df["n_tokens"] = df["utterance"].str.split().str.len()
    df["n_frames"] = df["frame_filenames"].str.len() \
        if "frame_filenames" in df.columns else 1

    rows = []
    for split, g in df.groupby("split", observed=True):
        rows.append({
            "split": str(split),
            "n_utterances": int(len(g)),
            "n_tokens": int(g["n_tokens"].sum()),
            "n_frames": int(g["n_frames"].sum()),
            "mean_utterance_length": float(g["n_tokens"].mean()),
            "mean_frames_per_utterance": float(g["n_frames"].mean()),
        })
    total = {
        "split": "TOTAL",
        "n_utterances": int(len(df)),
        "n_tokens": int(df["n_tokens"].sum()),
        "n_frames": int(df["n_frames"].sum()),
        "mean_utterance_length": float(df["n_tokens"].mean()),
        "mean_frames_per_utterance": float(df["n_frames"].mean()),
    }
    out = pd.DataFrame(rows + [total])
    if vocab_size is not None:
        out["vocab_size"] = vocab_size
    return out


def date_descriptives(saycam_df: "pandas.DataFrame") -> Dict[str, object]:
    """Recording-date stats from frame filenames (descriptives.py:108-132:
    SAYCam filenames embed the date as the second underscore field,
    e.g. S_20130601_...)."""
    import pandas as pd

    df = saycam_df.copy()
    df["date"] = pd.to_datetime(
        df["frame_filenames"].apply(lambda x: x[0].split("_")[1]),
        format="%Y%m%d")
    train = df[df["split"] == "train"].sort_values("date")
    first, last = train["date"].iloc[0], train["date"].iloc[-1]
    return {
        "first_date": str(first.date()),
        "last_date": str(last.date()),
        "span_days": int((last - first).days),
        "n_unique_dates": int(train["date"].nunique()),
    }


def category_word_freq_subsets(
    train_utterances, categories,
    subset_proportions=(1.0, 0.5, 0.25, 0.1),
) -> "pandas.DataFrame":
    """Long-form table of per-category word frequencies over date-ordered
    training prefixes (descriptives.py:136-170): columns category,
    subset_proportion, word_freq."""
    import pandas as pd

    utts = list(train_utterances)
    rows = []
    for p in subset_proportions:
        subset = utts[:int(len(utts) * p)]
        for c in categories:
            freq = sum(1 for u in subset if c in u.split())
            rows.append({"category": c, "subset_proportion": str(p),
                         "word_freq": freq})
    return pd.DataFrame(rows).sort_values("category").reset_index(
        drop=True)


def labeled_s_descriptives(labeled_s_dir,
                           train_utterances=None) -> "pandas.DataFrame":
    """Per-category Labeled-S image counts (+ training word frequency when
    utterances are given; descriptives.py:224-266)."""
    from pathlib import Path

    import pandas as pd

    rows = []
    for d in sorted(Path(labeled_s_dir).iterdir()):
        if not d.is_dir():
            continue
        n = sum(1 for p in d.iterdir() if p.suffix.lower() in
                (".jpeg", ".jpg", ".png"))
        row = {"category": d.name, "n_images": n}
        if train_utterances is not None:
            row["train_word_freq"] = sum(
                1 for u in train_utterances if d.name in u.split())
        rows.append(row)
    return pd.DataFrame(rows)
