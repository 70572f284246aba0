"""Joint-embedding analyses: category embeddings, image-text alignment,
2-D visualization coordinates (counterpart of
``multimodal_baby_tpu/analysis/embeddings.py``; reference:
analysis_cvcl/embeddings.py, t-SNE of joint image/text embeddings per eval
category, and analysis_cvcl/alignment.py, the image-text cosine alignment
table and the joint_embeddings_with_eval_sims CSV contract).

The image embeddings come from the model's ``encode_image`` in chunks of
``batch_size`` frames (on the card, through the trunk's kernel plan; an
int8 plan runs in bf16 on a chunk whose batch is not a multiple of 32), the
label embeddings from one ``encode_text`` call. The CSV writers, the
alignment table and t-SNE are host code, copied from the JAX package: they
need pandas, scipy and scikit-learn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.constants import MAX_LEN_UTTERANCE
from multimodal_baby_tpu_torch.evaluation.linear_probe import (
    extract_features)
from multimodal_baby_tpu_torch.models.multimodal import CVCL


@torch.no_grad()
def label_features(model: CVCL, vocab, labels) -> np.ndarray:
    """[C, E] text embeddings of one-word labels: each label's id at
    position 0 of a window of MAX_LEN_UTTERANCE, length 1."""
    device = next(model.parameters()).device
    ids = torch.zeros((len(labels), MAX_LEN_UTTERANCE), dtype=torch.long)
    ids[:, 0] = torch.tensor([vocab[c] for c in labels])
    lens = torch.ones((len(labels),), dtype=torch.long)
    feats, _ = model.encode_text(ids.to(device), lens.to(device))
    return feats.float().cpu().numpy()


def extract_joint_embeddings(
    model: CVCL, eval_dataset, batch_size: int = 64,
) -> Dict[str, np.ndarray]:
    """Image embeddings for every trial target + text embeddings for every
    category label. Returns dict with image_embeddings [N, E],
    text_embeddings [C, E], categories [N], category_names [C]."""
    imgs, cats = [], []
    for i in range(len(eval_dataset)):
        trial_imgs, ids, ln, cat = eval_dataset[i]
        imgs.append(trial_imgs[0])  # target image
        cats.append(cat)
    image_embeddings = extract_features(model, np.stack(imgs), batch_size)
    category_names = sorted(set(cats))
    return {
        "image_embeddings": image_embeddings,
        "text_embeddings": label_features(model, eval_dataset.vocab,
                                          category_names),
        "categories": np.asarray(cats),
        "category_names": np.asarray(category_names),
    }


def alignment_table(joint: Dict[str, np.ndarray]) -> "pandas.DataFrame":
    """Per-image cosine similarity to its own category label vs the mean of
    other labels (analysis_cvcl/alignment.py contract)."""
    import pandas as pd

    img = joint["image_embeddings"]
    txt = joint["text_embeddings"]
    img = img / np.linalg.norm(img, axis=1, keepdims=True)
    txt = txt / np.linalg.norm(txt, axis=1, keepdims=True)
    sims = img @ txt.T  # [N, C]
    names = list(joint["category_names"])
    rows = []
    for i, cat in enumerate(joint["categories"]):
        ci = names.index(cat)
        own = sims[i, ci]
        others = np.delete(sims[i], ci).mean()
        rows.append({"category": cat, "sim_to_own_label": own,
                     "sim_to_other_labels": others,
                     "alignment_margin": own - others})
    return pd.DataFrame(rows)


def tsne_coordinates(joint: Dict[str, np.ndarray], seed: int = 0,
                     perplexity: float = 30.0) -> np.ndarray:
    """2-D t-SNE of image + text embeddings stacked (images first)."""
    from sklearn.manifold import TSNE

    x = np.concatenate([joint["image_embeddings"],
                        joint["text_embeddings"]])
    perplexity = min(perplexity, max(2.0, (len(x) - 1) / 3))
    return TSNE(n_components=2, random_state=seed,
                perplexity=perplexity, init="pca").fit_transform(x)


# ---------------------------------------------------------------------------
# reference artifact contracts (analysis_cvcl/alignment.py + embeddings.py)
# ---------------------------------------------------------------------------

def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def write_alignment_csvs(
    mean_image_features: np.ndarray,   # [C, E] per-category mean image emb
    text_features: np.ndarray,         # [C, E] per-category label emb
    categories,                        # [C] names
    out_dir,
    model: str = "cvc",
    seed: int = 0,
):
    """The alignment.py output contract (alignment.py:180-231): two
    long-form CSVs over all category pairs —

      {model}_joint_embeddings_sims_seed_{seed}.csv
          image_sims, text_sims, eval_category_x, eval_category_y
      {model}_image_text_embeddings_sims_seed_{seed}.csv
          image_text_sims, eval_category_x, eval_category_y

    plus the alignment statistic the script prints: Pearson r between the
    upper-triangular image-image and text-text cosine similarities.
    Returns (joint_df, cross_df, (pearson_r, p_value)).
    """
    from pathlib import Path

    import pandas as pd
    from scipy import stats

    img = _unit(np.asarray(mean_image_features, np.float64))
    txt = _unit(np.asarray(text_features, np.float64))
    image_sims = img @ img.T
    text_sims = txt @ txt.T
    image_text_sims = img @ txt.T
    cats = list(categories)
    C = len(cats)
    xs = np.repeat(cats, C)
    ys = np.tile(cats, C)

    joint_df = pd.DataFrame({
        "image_sims": image_sims.ravel(),
        "text_sims": text_sims.ravel(),
        "eval_category_x": xs, "eval_category_y": ys})
    cross_df = pd.DataFrame({
        "image_text_sims": image_text_sims.ravel(),
        "eval_category_x": xs, "eval_category_y": ys})

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    joint_df.to_csv(
        out_dir / f"{model}_joint_embeddings_sims_seed_{seed}.csv",
        index=False)
    cross_df.to_csv(
        out_dir / f"{model}_image_text_embeddings_sims_seed_{seed}.csv",
        index=False)

    iu = np.triu_indices(C, k=1)
    r = stats.pearsonr(image_sims[iu], text_sims[iu])
    return joint_df, cross_df, (float(r[0]), float(r[1]))


def write_joint_embeddings_with_eval_sims(
    all_image_features: np.ndarray,    # [N, E] per-frame image embeddings
    mean_image_features: np.ndarray,   # [C, E]
    text_features: np.ndarray,         # [C, E]
    image_categories,                  # [N] category per frame
    image_filenames,                   # [N]
    categories,                        # [C] names
    out_csv,
    seed: int = 0,
    perplexity: float = 7.5,
):
    """The embeddings.py t-SNE CSV contract
    ({model}_joint_embeddings_with_eval_sims_seed_{seed}.csv,
    embeddings.py:122-183): rows = per-frame image embeddings, then
    per-category mean-image embeddings, then text embeddings; columns =
    t-SNE x/y (precomputed cosine-distance metric on the min-max-
    normalized similarity matrix), eval_category, image_filename,
    embedding_type, and one per-category column holding each frame's
    cosine similarity to that category's text embedding (0 for the
    mean/text rows)."""
    from pathlib import Path

    import pandas as pd
    from sklearn.manifold import TSNE

    cats = list(categories)
    feats = np.concatenate([all_image_features, mean_image_features,
                            text_features], axis=0)
    u = _unit(np.asarray(feats, np.float64))
    sims = u @ u.T
    sims = (sims - sims.min()) / max(sims.max() - sims.min(), 1e-12)
    perplexity = min(perplexity, max(2.0, (len(u) - 1) / 3))
    coords = TSNE(2, random_state=seed, metric="precomputed",
                  perplexity=perplexity, init="random"
                  ).fit_transform(1.0 - sims)
    df = pd.DataFrame(coords, columns=["x", "y"])
    n_img = len(all_image_features)
    df["eval_category"] = list(image_categories) + cats + cats
    df["image_filename"] = list(image_filenames) + [None] * (2 * len(cats))
    df["embedding_type"] = (["image"] * n_img
                            + ["image_mean"] * len(cats)
                            + ["text"] * len(cats))
    pad = np.zeros((2 * len(cats),))
    for ci, cat in enumerate(cats):
        sims_c = np.asarray(all_image_features) @ np.asarray(
            text_features)[ci]
        df[cat] = np.concatenate([sims_c, pad])

    out_csv = Path(out_csv)
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out_csv, index=False)
    return df


def category_feature_sets(
    model: CVCL, eval_frames_dir, vocab,
    n_samples: int = 100, seed: int = 0, batch_size: int = 64,
    kitty_swap: bool = True,
) -> Dict[str, np.ndarray]:
    """Extract the feature sets the alignment/embeddings artifacts consume
    (embeddings.py:60-104): up to ``n_samples`` frames per category ->
    per-frame features, per-category mean features, and per-label text
    features (with the reference's cat->kitty label swap)."""
    import glob
    import os

    from PIL import Image

    rng = np.random.RandomState(seed)
    eval_categories = sorted(
        d for d in os.listdir(eval_frames_dir)
        if os.path.isdir(os.path.join(eval_frames_dir, d)))

    all_feats, all_cats, all_files, mean_feats = [], [], [], []
    for cat in eval_categories:
        frames = sorted(
            glob.glob(os.path.join(eval_frames_dir, cat, "*.jpeg"))
            + glob.glob(os.path.join(eval_frames_dir, cat, "*.png"))
            + glob.glob(os.path.join(eval_frames_dir, cat, "*.jpg")))
        frames = list(rng.choice(frames, size=min(len(frames), n_samples),
                                 replace=False))
        imgs = np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((224, 224)))
            for p in frames])
        cat_feats = extract_features(model, imgs, batch_size)
        all_feats.append(cat_feats)
        mean_feats.append(cat_feats.mean(axis=0))
        all_cats += [cat] * len(frames)
        all_files += [os.path.join(*p.split(os.path.sep)[-4:])
                      for p in frames]

    labels = ["kitty" if (kitty_swap and c == "cat") else c
              for c in eval_categories]
    return {
        "all_image_features": np.concatenate(all_feats),
        "mean_image_features": np.stack(mean_feats),
        "text_features": label_features(model, vocab, labels),
        "image_categories": np.asarray(all_cats),
        "image_filenames": np.asarray(all_files),
        "categories": np.asarray(eval_categories),
    }
