"""CogSci-toolchain processing: run (neural or n-gram) LMs over a dataset
collecting per-token losses and hidden states, then aggregate per word
(counterpart of ``multimodal_baby_tpu/analysis/processing.py``; reference:
analysis_tools/processing.py:158-249, sumdata.py and token_items_data.py).

``collect_token_data`` runs one ``lm_forward`` per batch without autograd
(the LSTM's recurrence through K9 where the model's ``fused_lstm`` rule
says so), then the shifted labels and the tokenwise cross-entropy; the
aggregation is host code copied from the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.constants import (
    EOS_TOKEN_ID, PAD_TOKEN_ID, SOS_TOKEN_ID)
from multimodal_baby_tpu_torch.models.losses import lm_cross_entropy
from multimodal_baby_tpu_torch.models.multimodal import CVCL


@torch.no_grad()
def collect_token_data(
    model: CVCL, batches, vocab,
    collect_hidden: bool = False,
) -> Dict[str, np.ndarray]:
    """Run the LM over batches of (text, text_len), returning flat arrays
    of (token_id, position, ce_loss[, hidden]) for every non-PAD token."""
    device = next(model.parameters()).device
    token_ids: List[np.ndarray] = []
    positions: List[np.ndarray] = []
    losses: List[np.ndarray] = []
    hiddens: List[np.ndarray] = []
    for batch in batches:
        text = torch.as_tensor(batch["text"]).to(device, torch.long)
        text_len = torch.as_tensor(batch["text_len"]).to(device, torch.long)
        outputs, logits, _ = model.lm_forward(text, text_len)
        labels, logits = model.lm_labels_and_logits(text, logits)
        ce, mask = lm_cross_entropy(logits, labels)
        ce, mask, labels = (t.cpu().numpy() for t in (ce, mask, labels))
        idx = np.nonzero(mask)
        token_ids.append(labels[idx])
        positions.append(idx[1])
        losses.append(ce[idx])
        if collect_hidden:
            out = outputs.float().cpu().numpy()
            # hidden state at the step predicting this token
            hiddens.append(out[idx[0], idx[1]])

    result = {
        "token_id": np.concatenate(token_ids),
        "position": np.concatenate(positions),
        "ce_loss": np.concatenate(losses),
    }
    if collect_hidden:
        result["hidden"] = np.concatenate(hiddens)
    result["token"] = np.asarray(
        [vocab.idx2word[int(t)] for t in result["token_id"]])
    return result


def per_word_summary(token_data: Dict[str, np.ndarray]
                     ) -> "pandas.DataFrame":
    """Per-word mean loss / frequency table (sumdata.py contract)."""
    import pandas as pd

    df = pd.DataFrame({
        "token": token_data["token"],
        "ce_loss": token_data["ce_loss"],
        "position": token_data["position"],
    })
    return (df.groupby("token")
            .agg(mean_ce=("ce_loss", "mean"),
                 count=("ce_loss", "size"),
                 mean_position=("position", "mean"))
            .reset_index()
            .sort_values("count", ascending=False))


def mean_hidden_per_word(token_data: Dict[str, np.ndarray],
                         min_count: int = 1) -> Dict[str, np.ndarray]:
    """Mean hidden state per word — the representation fed to RSA /
    clustering analyses (analysis_tools/processing.py + plotting.py)."""
    assert "hidden" in token_data, "collect_hidden=True required"
    words, inv = np.unique(token_data["token"], return_inverse=True)
    dim = token_data["hidden"].shape[1]
    sums = np.zeros((len(words), dim), np.float64)
    counts = np.zeros(len(words), np.int64)
    np.add.at(sums, inv, token_data["hidden"])
    np.add.at(counts, inv, 1)
    keep = counts >= min_count
    return {"words": words[keep],
            "mean_hidden": (sums[keep] / counts[keep, None]).astype(
                np.float32),
            "counts": counts[keep]}


def sentence_batches(utterances, vocab, batch_size: int = 64,
                     max_len: int = 25):
    """Sentence-only batches for LM analyses
    (analysis_tools/sentences_data.py): <sos> tokens <eos>, padded to
    ``max_len``; yields {"text": [B, L] int32, "text_len": [B]} dicts
    consumable by collect_token_data."""
    utterances = list(utterances)
    for s in range(0, len(utterances), batch_size):
        chunk = utterances[s:s + batch_size]
        ids = np.full((len(chunk), max_len), PAD_TOKEN_ID, np.int32)
        lens = np.zeros((len(chunk),), np.int32)
        for i, utt in enumerate(chunk):
            toks = [SOS_TOKEN_ID] + [
                vocab.get(w) for w in utt.split()] + [EOS_TOKEN_ID]
            toks = toks[:max_len]
            ids[i, :len(toks)] = toks
            lens[i] = len(toks)
        yield {"text": ids, "text_len": lens}


def build_data(overrides: Optional[dict] = None, deterministic: bool = True):
    """A deterministic DataModule for analyses
    (analysis_tools/build_data.py): augmentation and random frame
    sampling off, sos/eos included in eval labels, so repeated passes see
    identical batches. ``overrides`` patch DataConfig fields."""
    from multimodal_baby_tpu_torch.core.config import DataConfig
    from multimodal_baby_tpu_torch.data.modules import DataModule

    cfg = DataConfig()
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)
    if deterministic:
        cfg.augment_frames = False
        cfg.multiple_frames = False
        cfg.eval_include_sos_eos = True
    return DataModule(cfg).setup()
