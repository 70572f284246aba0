"""Token-items table: the CogSci toolchain's central data layer; a copy of
``multimodal_baby_tpu/analysis/token_items.py`` on the port's
``word_analysis``. PCA and t-SNE need scikit-learn, imported where used.

Capability parity with analysis_tools/token_items_data.py + sumdata.py:
one row per token type, columns holding count/log-count, POS tag and the
paper's compressed syntactic category, per-model mean loss / probability /
perplexity, loss- and prob-diffs against a baseline model, 2-D t-SNE and
PCA coordinates of each model's mean hidden vectors, curated word
categories, and optional external-ratings joins (word_ratings.py).

Input is the per-run ``token_data`` produced by
analysis.processing.collect_token_data (losses + optional hidden states
per token occurrence), so the whole CogSci pipeline is:

    collect_token_data (per model) -> build_token_items -> plotting/RSA
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

PPL_CAP = 99999.99  # sumdata.py:18 caps perplexity


def _per_token_stats(token_data: Dict[str, np.ndarray]):
    """(words, counts, mean_loss, mean_hidden|None) per token type."""
    words, inv = np.unique(token_data["token"], return_inverse=True)
    counts = np.bincount(inv, minlength=len(words))
    loss_sums = np.bincount(inv, weights=token_data["ce_loss"],
                            minlength=len(words))
    mean_hidden = None
    if "hidden" in token_data:
        dim = token_data["hidden"].shape[1]
        sums = np.zeros((len(words), dim), np.float64)
        np.add.at(sums, inv, token_data["hidden"])
        mean_hidden = (sums / counts[:, None]).astype(np.float32)
    return words, counts, loss_sums / counts, mean_hidden


def _embed_2d(x: np.ndarray, method: str, seed: int = 0) -> np.ndarray:
    if method == "pca":
        from sklearn.decomposition import PCA
        return PCA(n_components=min(2, x.shape[1])).fit_transform(x)
    from sklearn.manifold import TSNE
    perplexity = min(30.0, max(2.0, (len(x) - 1) / 3))
    return TSNE(2, random_state=seed,
                perplexity=perplexity).fit_transform(x)


def build_token_items(
    runs: Dict[str, Dict[str, np.ndarray]],
    vocab=None,
    baseline_name: Optional[str] = None,
    pos_tags: Optional[Dict[str, str]] = None,
    min_count: int = 1,
    embed_methods=("tsne",),
    ratings_csv=None,
    seed: int = 0,
) -> "pandas.DataFrame":
    """runs: {model_name: token_data}; the first (or ``baseline_name``)
    model is the diff baseline (token_items_data.py:107-116)."""
    import pandas as pd

    from multimodal_baby_tpu_torch.analysis.word_analysis import (
        DEFAULT_WORD_CATEGORIES, UNTYPICAL_WORDS, pos_tag,
        syntactic_category, word_to_category)

    names = list(runs)
    if baseline_name is None:
        baseline_name = names[0]

    # union of token types over runs, count from the baseline run
    base_words, base_counts, _, _ = _per_token_stats(runs[baseline_name])
    keep = base_counts >= min_count
    words = base_words[keep]
    items = pd.DataFrame({"token": words,
                          "cnt": base_counts[keep]})
    items["logcnt"] = np.log(items["cnt"])
    if vocab is not None:
        items["token_id"] = [vocab[w] for w in words]

    # POS + the paper's syntactic-category compression
    tags = pos_tags or pos_tag(list(words))
    items["pos"] = items["token"].map(tags)
    items["syntactic category"] = items["pos"].map(syntactic_category)
    w2c = word_to_category(DEFAULT_WORD_CATEGORIES)
    items["word category"] = items["token"].map(w2c).fillna("other")
    items["untypical"] = items["token"].isin(UNTYPICAL_WORDS)

    word_index = {w: i for i, w in enumerate(words)}
    for name in names:
        run_words, _, mean_loss, mean_hidden = _per_token_stats(runs[name])
        loss_col = np.full(len(words), np.nan)
        for w, ml in zip(run_words, mean_loss):
            i = word_index.get(w)
            if i is not None:
                loss_col[i] = ml
        items[f"{name} loss"] = loss_col
        items[f"{name} prob"] = np.exp(-loss_col)
        items[f"{name} ppl"] = np.minimum(np.exp(loss_col), PPL_CAP)
        if name != baseline_name:
            for attr in ("loss", "prob"):
                items[f"{name} {attr} - {baseline_name} {attr}"] = (
                    items[f"{name} {attr}"]
                    - items[f"{baseline_name} {attr}"])
        if mean_hidden is not None and len(run_words) > 3:
            sel = np.asarray([word_index.get(w, -1) for w in run_words])
            ok = sel >= 0
            for method in embed_methods:
                coords = _embed_2d(mean_hidden[ok], method, seed=seed)
                for d in range(coords.shape[1]):
                    col = np.full(len(words), np.nan)
                    col[sel[ok]] = coords[:, d]
                    items[f"{name} {method} {d}"] = col

    if ratings_csv is not None:
        from multimodal_baby_tpu_torch.analysis.word_analysis import join_ratings
        items = join_ratings(items, ratings_csv)
    return items
