"""The CVCL embedding text encoder (Vong et al. 2024; the reference
repository's ``TextEncoder`` with ``text_encoder="embedding"``), float32:
the token embeddings, summed over the padded window and divided by the
utterance's length. Lookups of the padding token (id 0) pass no gradient
to its row."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.weights import Spec

PAD = 0


def spec(prefix: str, vocab: int, dim: int, max_len: int) -> Spec:
    return [(f"{prefix}embedding.weight", (vocab, dim), ("embedding",))]


def lookup(w: Dict[str, torch.Tensor], ids: torch.Tensor,
           prefix: str = "") -> torch.Tensor:
    return F.embedding(ids, w[f"{prefix}embedding.weight"], padding_idx=PAD)


def mean_over_window(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1) / lens.float()[:, None]


def encode(w: Dict[str, torch.Tensor], ids: torch.Tensor,
           lens: torch.Tensor, prefix: str = "",
           draw: Optional[Callable] = None) -> torch.Tensor:
    """ids [B, L], lens [B] -> the flat text feature [B, dim]; the encoder
    has no dropout, so ``draw`` is not used."""
    return mean_over_window(lookup(w, ids, prefix), lens)
