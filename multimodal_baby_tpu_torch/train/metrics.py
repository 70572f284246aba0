"""Epoch-level metric aggregation and logging (counterpart of
``multimodal_baby_tpu/train/metrics.py``, the same weighting).

Contrastive metrics are means over *examples* (weighted by batch size), LM
losses means over *tokens* (weighted by token counts), with perplexity =
exp(token-mean CE) (reference: multimodal_lit.py:377-443).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

PER_EXAMPLE_METRICS = (
    "infonce_loss", "image_accuracy", "text_accuracy",
    "image_entropy", "text_entropy", "attn_reg_loss", "loss",
)
PER_TOKEN_METRICS = {
    "ce_loss": "n_tokens",
    "ce_loss_wo_sos": "n_tokens_wo_sos",
    "ce_loss_wo_sos_eos": "n_tokens_wo_sos_eos",
}


def aggregate_epoch(outputs: List[Dict[str, float]]) -> Dict[str, float]:
    """outputs: per-step metric dicts (already host floats)."""
    agg: Dict[str, float] = {}
    if not outputs:
        return agg

    n_examples = sum(o["batch_size"] for o in outputs)
    for name in PER_EXAMPLE_METRICS:
        if name in outputs[0]:
            agg[name] = sum(
                o[name] * o["batch_size"] for o in outputs) / n_examples

    for name, n_name in PER_TOKEN_METRICS.items():
        if name in outputs[0]:
            n_tokens = sum(o[n_name] for o in outputs)
            agg[name] = sum(o[name] * o[n_name] for o in outputs) / n_tokens
            agg[name.replace("ce_loss", "perplexity")] = math.exp(agg[name])

    if "temperature" in outputs[-1]:
        agg["temperature"] = outputs[-1]["temperature"]
    return agg


def to_host(metrics) -> Dict[str, float]:
    """A step's metrics (tensors on the device, or numbers) as host floats:
    the one place the trainer reads them back."""
    return {k: float(v) for k, v in metrics.items()
            if not isinstance(v, (list, str))}


class MetricsLogger:
    """JSONL logger (one line per event) into ``log_dir/filename``, always
    written, with optional wandb mirroring (the reference's WandbLogger,
    train.py:92-100)."""

    def __init__(self, log_dir, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None,
                 filename: str = "metrics.jsonl"):
        self.path = Path(log_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        record = {f"{prefix}{k}": v for k, v in metrics.items()}
        record["step"] = step
        record["time"] = time.time()
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.wandb is not None:
            self.wandb.log(record, step=step)

    def close(self):
        self._file.close()
