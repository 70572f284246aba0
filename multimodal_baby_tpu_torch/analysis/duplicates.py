"""Train/eval frame-leak audit: a copy of
``multimodal_baby_tpu/analysis/duplicates.py``, kept so that the port
imports nothing of the JAX package. The feature extractor ``embed_fn``
is the caller's (``cli/analyze.py`` passes the model's image
embeddings through its kernel plan).

Capability parity with analysis_cvcl/duplicates.py: perceptual-hash
duplicate detection (:28-42) and feature-space nearest-neighbor cosine
duplicates (:439-621), numpy-based.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def average_hash(image_u8: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """aHash: downscale to hash_size^2 grayscale, threshold at the mean.
    Returns a flat boolean array."""
    from PIL import Image

    img = Image.fromarray(image_u8).convert("L").resize(
        (hash_size, hash_size), Image.BILINEAR)
    a = np.asarray(img, np.float32)
    return (a > a.mean()).reshape(-1)


def hash_distance(h1: np.ndarray, h2: np.ndarray) -> int:
    return int(np.count_nonzero(h1 != h2))


def find_hash_duplicates(
    hashes_a: np.ndarray,   # [N, 64] bool
    hashes_b: np.ndarray,   # [M, 64] bool
    max_distance: int = 5,
) -> List[Tuple[int, int, int]]:
    """All (i, j, dist) pairs with Hamming distance <= max_distance."""
    # vectorized hamming via xor-popcount on packed uint64 would be faster;
    # at corpus scale (<1e5 frames) the [N, M] bool matmul is fine
    a = hashes_a.astype(np.int8)
    b = hashes_b.astype(np.int8)
    dists = (a[:, None, :] != b[None, :, :]).sum(-1) \
        if a.shape[0] * b.shape[0] <= 4_000_000 else None
    out = []
    if dists is not None:
        ii, jj = np.nonzero(dists <= max_distance)
        return [(int(i), int(j), int(dists[i, j])) for i, j in zip(ii, jj)]
    for i in range(a.shape[0]):
        d = (a[i][None, :] != b).sum(-1)
        for j in np.nonzero(d <= max_distance)[0]:
            out.append((i, int(j), int(d[j])))
    return out


def find_feature_duplicates(
    feats_a: np.ndarray, feats_b: np.ndarray,
    threshold: float = 0.98,
) -> List[Tuple[int, int, float]]:
    """Cosine-similarity near-duplicates between two feature sets
    (duplicates.py:439-621 pattern)."""
    a = feats_a / np.maximum(
        np.linalg.norm(feats_a, axis=1, keepdims=True), 1e-12)
    b = feats_b / np.maximum(
        np.linalg.norm(feats_b, axis=1, keepdims=True), 1e-12)
    sims = a @ b.T
    ii, jj = np.nonzero(sims >= threshold)
    return [(int(i), int(j), float(sims[i, j])) for i, j in zip(ii, jj)]


# ---------------------------------------------------------------------------
# the full train/eval leak-audit workflow (duplicates.py:439-868)
# ---------------------------------------------------------------------------

def category_frame_lists(train_metadata: List[dict],
                         eval_metadata: List[dict],
                         categories: List[str]):
    """Per-category frame lists: training frames of utterances containing
    the category word (duplicates.py:471-478), and eval target frames per
    category (:481-487)."""
    train_frames = {c: [] for c in categories}
    for item in train_metadata:
        words = set(item["utterance"].split(" "))
        for c in categories:
            if c in words:
                train_frames[c].extend(item["frame_filenames"])
    eval_frames = {c: [] for c in categories}
    for item in eval_metadata:
        c = item["target_category"]
        if c in eval_frames:
            eval_frames[c].append(item["target_img_filename"])
    return train_frames, eval_frames


def run_leak_audit(
    train_metadata: List[dict],
    eval_metadata: List[dict],
    embed_fn,                  # list[str] paths -> [N, D] features
    out_dir,
    categories: List[str] = None,
    thresholds=(0.99, 0.95, 0.9),
    visualize_top_k: int = 8,
    load_image=None,           # path -> uint8 array (for the NN grids)
) -> dict:
    """The reference's duplicate-audit artifacts from metadata + a feature
    extractor (the reference uses the frozen dino_sfp_resnext50,
    duplicates.py:489-494; any embed_fn works — inject the CVCL trunk):

      matched_results.csv   eval_filename, train_filename, cosine_sim,
                            matched (column contract of :866-868)
      duplicates_report.json  per-category counts + proportions over
                            `thresholds` (the printed stats of :622-632)
      nn_pairs.png          top-k nearest train/eval pairs side by side
                            (the visualization of :622-687), when
                            ``load_image`` is given

    Returns the report dict.
    """
    import json as _json
    from pathlib import Path

    import pandas as pd

    if categories is None:
        categories = sorted({e["target_category"] for e in eval_metadata})
    train_frames, eval_frames = category_frame_lists(
        train_metadata, eval_metadata, categories)

    rows = []
    per_category = {}
    for c in categories:
        tf, ef = train_frames[c], eval_frames[c]
        if not tf or not ef:
            per_category[c] = {"n_train": len(tf), "n_eval": len(ef),
                               "n_over": {str(t): 0 for t in thresholds}}
            continue
        t_feat = np.asarray(embed_fn(tf))
        e_feat = np.asarray(embed_fn(ef))
        t_feat = t_feat / np.maximum(
            np.linalg.norm(t_feat, axis=1, keepdims=True), 1e-12)
        e_feat = e_feat / np.maximum(
            np.linalg.norm(e_feat, axis=1, keepdims=True), 1e-12)
        sims = t_feat @ e_feat.T                   # [n_train, n_eval]
        best = sims.argmax(axis=0)                 # per eval frame
        best_sim = sims.max(axis=0)
        for j, (bi, bs) in enumerate(zip(best, best_sim)):
            rows.append({"eval_filename": ef[j],
                         "train_filename": tf[int(bi)],
                         "cosine_sim": float(bs),
                         "matched": True,
                         "category": c})
        per_category[c] = {
            "n_train": len(tf), "n_eval": len(ef),
            "n_over": {str(t): int((best_sim > t).sum())
                       for t in thresholds}}

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    df = pd.DataFrame(
        rows, columns=["eval_filename", "train_filename", "cosine_sim",
                       "matched", "category"])
    df.to_csv(out_dir / "matched_results.csv", index=False)

    all_sims = df["cosine_sim"].to_numpy() if len(df) else np.zeros((0,))
    report = {
        "n_pairs": int(len(df)),
        "proportions_over": {
            str(t): float((all_sims > t).mean()) if len(df) else 0.0
            for t in thresholds},
        "per_category": per_category,
    }
    (out_dir / "duplicates_report.json").write_text(_json.dumps(report,
                                                                indent=2))

    if load_image is not None and len(df):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        top = df.sort_values("cosine_sim", ascending=False).head(
            visualize_top_k)
        k = len(top)
        fig, axes = plt.subplots(k, 2, figsize=(6, 3 * k), squeeze=False)
        for r, (_, row) in enumerate(top.iterrows()):
            for c_idx, key in enumerate(("train_filename",
                                         "eval_filename")):
                try:
                    axes[r][c_idx].imshow(load_image(row[key]))
                except Exception:
                    pass
                axes[r][c_idx].set_axis_off()
            axes[r][0].set_title(
                f"cos={row['cosine_sim']:.3f} ({row['category']})",
                fontsize=8)
        fig.tight_layout()
        fig.savefig(out_dir / "nn_pairs.png", dpi=120)
        plt.close(fig)

        plt.figure(figsize=(5, 3))
        plt.hist(all_sims, bins=np.arange(0, 1.05, 0.05), rwidth=0.9)
        plt.xlim(0, 1)
        plt.xlabel("Cosine Similarity")
        plt.ylabel("Count")
        plt.savefig(out_dir / "nearest_neighbor_cosine_similarity.png",
                    dpi=120)
        plt.close()

    return report
