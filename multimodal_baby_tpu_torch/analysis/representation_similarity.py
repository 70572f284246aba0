"""Representation similarity analysis (RSA): a copy of
``multimodal_baby_tpu/analysis/representation_similarity.py``, kept so
that the port imports nothing of the JAX package.

Capability parity with analysis_tools/representation_similarity.py:30-39:
cosine similarity matrices of two representation sets, correlated over the
upper triangle (Pearson or Spearman).
"""

from __future__ import annotations

import numpy as np


def cosine_similarity_matrix(x: np.ndarray) -> np.ndarray:
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return xn @ xn.T


def rsa(x: np.ndarray, y: np.ndarray, method: str = "pearson") -> float:
    """Correlation of the upper-triangle similarity structures of two
    representation matrices [N, Dx], [N, Dy]."""
    assert x.shape[0] == y.shape[0]
    sx = cosine_similarity_matrix(x)
    sy = cosine_similarity_matrix(y)
    iu = np.triu_indices(x.shape[0], k=1)
    a, b = sx[iu], sy[iu]
    if method == "spearman":
        from scipy.stats import spearmanr
        return float(spearmanr(a, b).statistic)
    return float(np.corrcoef(a, b)[0, 1])
