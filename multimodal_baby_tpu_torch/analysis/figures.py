"""Paper-figure equivalents of the reference's R scripts: a copy of
``multimodal_baby_tpu/analysis/figures.py`` (matplotlib is imported with
the module).

The reference renders its Science-paper figures from the summary CSVs in
R/tidyverse (analysis_cvcl/figures.R) and its corpus descriptives in
analysis_cvcl/descriptives.R; both consume the artifacts produced by
clean.py / descriptives.py. These are the same figures in matplotlib,
consuming the same CSV contracts (analysis/summaries.py,
analysis/descriptives.py), so the figure layer no longer needs R.

All functions take a summary DataFrame (or CSV path), return the
matplotlib Figure, and optionally save; headless-safe (Agg).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

CHANCE_4WAY = 0.25


def _as_df(summary: Union[str, Path, "pandas.DataFrame"]):
    import pandas as pd

    if isinstance(summary, (str, Path)):
        return pd.read_csv(summary)
    return summary


def _save(fig, save_path):
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def _bootstrap_ci(values: np.ndarray, n_boot: int = 1000, alpha: float = .05,
                  seed: int = 0):
    """Percentile bootstrap CI of the mean (figures.R uses tidyboot's
    equivalent); returns (lo, hi)."""
    rng = np.random.RandomState(seed)
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return (np.nan, np.nan)
    idx = rng.randint(0, len(values), (n_boot, len(values)))
    means = values[idx].mean(axis=1)
    return (np.quantile(means, alpha / 2),
            np.quantile(means, 1 - alpha / 2))


def fig_eval_accuracy(summary, save_path=None, *,
                      by: str = "target_category",
                      chance: float = CHANCE_4WAY,
                      title: str = "Labeled-S zero-shot accuracy"):
    """Per-category forced-choice accuracy, sorted, with bootstrap CIs,
    the overall mean, and the chance line (Science Fig. 2 style)."""
    df = _as_df(summary)
    cats = sorted(df[by].unique(),
                  key=lambda c: -df[df[by] == c]["correct"].mean())
    means, lows, highs = [], [], []
    for c in cats:
        v = df[df[by] == c]["correct"].to_numpy(np.float64)
        lo, hi = _bootstrap_ci(v)
        means.append(v.mean())
        lows.append(lo)
        highs.append(hi)
    overall = df["correct"].mean()

    fig, ax = plt.subplots(figsize=(max(6, 0.4 * len(cats) + 2), 4))
    x = np.arange(len(cats))
    ax.bar(x, means, color="#4878cf",
           yerr=[np.asarray(means) - lows, np.asarray(highs) - means],
           capsize=2, error_kw={"lw": 0.8})
    ax.axhline(chance, ls="--", color="gray", lw=1, label=f"chance {chance:.2f}")
    ax.axhline(overall, ls="-", color="#d1495b", lw=1,
               label=f"overall {overall:.3f}")
    ax.set_xticks(x)
    ax.set_xticklabels(cats, rotation=60, ha="right", fontsize=8)
    ax.set_ylabel("accuracy")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.legend(fontsize=8, loc="upper right")
    return _save(fig, save_path)


def fig_config_comparison(summary, save_path=None, *,
                          config_col: str = "config",
                          hue_col: Optional[str] = None,
                          chance: float = CHANCE_4WAY,
                          title: str = "Model comparison"):
    """Mean accuracy per config (ablations / bounds figure): bars with
    bootstrap CIs over trials, optionally grouped (e.g. filtered/split)."""
    df = _as_df(summary)
    configs = list(dict.fromkeys(df[config_col]))
    hues = (list(dict.fromkeys(df[hue_col])) if hue_col else [None])
    width = 0.8 / len(hues)

    fig, ax = plt.subplots(figsize=(max(5, 0.8 * len(configs) + 2), 4))
    cmap = plt.get_cmap("tab10")
    for j, hue in enumerate(hues):
        sub = df if hue is None else df[df[hue_col] == hue]
        means, errs = [], []
        for cfg in configs:
            v = sub[sub[config_col] == cfg]["correct"].to_numpy(np.float64)
            lo, hi = _bootstrap_ci(v)
            means.append(v.mean() if len(v) else np.nan)
            errs.append((means[-1] - lo, hi - means[-1]))
        x = np.arange(len(configs)) + (j - (len(hues) - 1) / 2) * width
        ax.bar(x, means, width=width * 0.9, color=cmap(j),
               yerr=np.asarray(errs).T, capsize=2, error_kw={"lw": 0.8},
               label=str(hue) if hue is not None else None)
    ax.axhline(chance, ls="--", color="gray", lw=1)
    ax.set_xticks(np.arange(len(configs)))
    ax.set_xticklabels(configs, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("accuracy")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    if hue_col:
        ax.legend(title=hue_col, fontsize=8)
    return _save(fig, save_path)


def fig_seed_consistency(summary, save_path=None, *,
                         config_col: str = "config",
                         title: str = "Per-seed accuracy"):
    """Per-seed overall accuracy per config (the seed-dots overlay of
    figures.R): one point per (config, seed)."""
    df = _as_df(summary)
    configs = list(dict.fromkeys(df[config_col]))
    fig, ax = plt.subplots(figsize=(max(5, 0.8 * len(configs) + 2), 4))
    for i, cfg in enumerate(configs):
        sub = df[df[config_col] == cfg]
        accs = sub.groupby("seed")["correct"].mean()
        jitter = (np.random.RandomState(i).rand(len(accs)) - 0.5) * 0.2
        ax.scatter(np.full(len(accs), i) + jitter, accs.to_numpy(),
                   s=24, color="#4878cf", alpha=0.8, zorder=3)
        ax.scatter([i], [sub["correct"].mean()], marker="_", s=600,
                   color="#d1495b", zorder=4)
    ax.axhline(CHANCE_4WAY, ls="--", color="gray", lw=1)
    ax.set_xticks(np.arange(len(configs)))
    ax.set_xticklabels(configs, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel("accuracy")
    ax.set_ylim(0, 1)
    ax.set_title(title)
    return _save(fig, save_path)


def fig_corpus_descriptives(utterances: Sequence[str], save_path=None, *,
                            title: str = "Corpus descriptives"):
    """descriptives.R panel: token-frequency rank plot (log-log) and the
    utterance-length histogram."""
    from collections import Counter

    counts = Counter(w for u in utterances for w in str(u).split())
    freqs = np.asarray(sorted(counts.values(), reverse=True), np.float64)
    lengths = np.asarray([len(str(u).split()) for u in utterances])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.loglog(np.arange(1, len(freqs) + 1), freqs, lw=1.2, color="#4878cf")
    ax1.set_xlabel("word rank")
    ax1.set_ylabel("frequency")
    ax1.set_title(f"{len(counts)} types / {int(freqs.sum())} tokens")
    ax2.hist(lengths, bins=np.arange(0.5, lengths.max() + 1.5),
             color="#4878cf", edgecolor="white")
    ax2.axvline(lengths.mean(), color="#d1495b", lw=1,
                label=f"mean {lengths.mean():.2f}")
    ax2.set_xlabel("utterance length (tokens)")
    ax2.set_ylabel("count")
    ax2.legend(fontsize=8)
    fig.suptitle(title)
    return _save(fig, save_path)


def render_all(summary_csv, out_dir, utterances=None) -> list:
    """Render every figure the summary supports; returns written paths."""
    import pandas as pd

    out_dir = Path(out_dir)
    df = _as_df(summary_csv)
    written = []

    def emit(name, fn, *a, **k):
        path = out_dir / name
        fn(*a, save_path=path, **k)
        plt.close("all")
        written.append(path)

    emit("eval_accuracy.png", fig_eval_accuracy, df)
    if "config" in df.columns and df["config"].nunique() > 1:
        hue = next((c for c in ("filtered", "split")
                    if c in df.columns and df[c].nunique() > 1), None)
        emit("config_comparison.png", fig_config_comparison, df,
             hue_col=hue)
    if "seed" in df.columns and df["seed"].nunique() > 1:
        emit("seed_consistency.png", fig_seed_consistency, df)
    if utterances is not None:
        emit("corpus_descriptives.png", fig_corpus_descriptives, utterances)
    return written
