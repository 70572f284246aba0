"""Figure utilities, a copy of ``multimodal_baby_tpu/analysis/plotting.py``
(matplotlib is imported with the module; analysis_tools/plotting.py
parity): embedding
scatter plots, word-similarity heatmaps, hierarchical-clustering
dendrograms. All functions return the matplotlib Figure and optionally save
to disk; headless-safe (Agg backend)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _save(fig, save_path):
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def scatter_embeddings(coords: np.ndarray, labels: Sequence[str],
                       title: str = "", save_path=None,
                       highlight: Optional[Sequence[str]] = None):
    """2-D scatter colored by label (t-SNE visualization of joint
    embeddings, analysis_cvcl/embeddings.py style)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    uniq = sorted(set(labels))
    cmap = plt.get_cmap("tab20")
    for i, lab in enumerate(uniq):
        mask = np.asarray([l == lab for l in labels])
        ax.scatter(coords[mask, 0], coords[mask, 1], s=12,
                   color=cmap(i % 20), label=lab,
                   alpha=1.0 if (highlight and lab in highlight) else 0.6)
    ax.legend(fontsize=6, ncol=2, markerscale=1.5)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    return _save(fig, save_path)


def similarity_heatmap(matrix: np.ndarray, labels: Sequence[str],
                       title: str = "", save_path=None):
    fig, ax = plt.subplots(
        figsize=(max(6, len(labels) * 0.3),) * 2)
    im = ax.imshow(matrix, cmap="viridis")
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=6)
    ax.set_yticklabels(labels, fontsize=6)
    fig.colorbar(im)
    ax.set_title(title)
    return _save(fig, save_path)


def dendrogram(features: np.ndarray, labels: Sequence[str],
               method: str = "average", metric: str = "cosine",
               title: str = "", save_path=None):
    """Hierarchical clustering of per-word representations
    (analysis_tools dendrogram figures; scipy linkage instead of the
    vendored hierarchy module)."""
    from scipy.cluster.hierarchy import dendrogram as scipy_dendrogram
    from scipy.cluster.hierarchy import linkage

    link = linkage(features, method=method, metric=metric)
    fig, ax = plt.subplots(figsize=(max(6, len(labels) * 0.2), 6))
    scipy_dendrogram(link, labels=list(labels), ax=ax, leaf_font_size=7)
    ax.set_title(title)
    return _save(fig, save_path)


# ---------------------------------------------------------------------------
# frame-visualization helpers (analysis_tools/frame_visualization.py)
# ---------------------------------------------------------------------------

def frame_subplots(nrows=1, ncols=1, fig_width=8.0,
                   wspace=0.025, hspace=0.25, aspect=1.0, **kwargs):
    """Subplot grid sized so every frame keeps its aspect ratio
    (frame_visualization.py:6-25). Returns (fig, axes, frame_width)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frame_width = fig_width / (ncols + (ncols - 1) * wspace)
    frame_height = frame_width / aspect
    fig_height = frame_height * (nrows + (nrows - 1) * hspace)
    fig, ax = plt.subplots(
        nrows, ncols, figsize=(fig_width, fig_height), squeeze=False,
        gridspec_kw={"wspace": wspace, "hspace": hspace}, **kwargs)
    return fig, ax, frame_width


def untokenize(utterance: str) -> str:
    """Space-tokenized utterance -> display string: glue punctuation and
    clitics back (frame_visualization.py:28-29)."""
    import re
    return re.sub(r" (?=([\.\?\!,']|((n('|)t|na)\b)))", r"", utterance)
