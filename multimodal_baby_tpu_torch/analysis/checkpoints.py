"""Registry of paper/experiment checkpoints (counterpart of
``multimodal_baby_tpu/analysis/checkpoints.py``).

Parity with analysis_tools/checkpoints.py: a single place mapping
experiment names -> checkpoint locations + configs, so analysis scripts can
enumerate models. Populated from a checkpoints/ directory (each experiment
directory of the port's trainer holds its config.json and index.json) and
extensible with external entries. ``load`` builds the model on ``device``,
the card by default.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator


class CheckpointRegistry:
    def __init__(self, checkpoint_root: str = "checkpoints"):
        self.root = Path(checkpoint_root)
        self.extra: Dict[str, dict] = {}

    def register(self, name: str, path, **meta) -> None:
        self.extra[name] = {"path": str(path), **meta}

    def scan(self) -> Dict[str, dict]:
        """Discover all native checkpoints under the root."""
        found: Dict[str, dict] = {}
        if self.root.exists():
            for cfg_path in sorted(self.root.glob("*/config.json")):
                exp_dir = cfg_path.parent
                index = {}
                idx_path = exp_dir / "index.json"
                if idx_path.exists():
                    index = json.loads(idx_path.read_text())
                cfg = json.loads(cfg_path.read_text())
                found[exp_dir.name] = {
                    "path": str(exp_dir),
                    "text_encoder": cfg["model"]["text"]["text_encoder"],
                    "embedding_dim": cfg["model"]["embedding_dim"],
                    "seed": cfg["train"]["seed"],
                    "best_val_loss": (index.get("best") or [{}])[0].get(
                        "val_loss"),
                    "last_epoch": (index.get("last") or {}).get("epoch"),
                }
        found.update(self.extra)
        return found

    def __iter__(self) -> Iterator[str]:
        return iter(self.scan())

    def load(self, name: str, device="cuda"):
        from multimodal_baby_tpu_torch.api.model import CVCLModel
        entry = self.scan()[name]
        return CVCLModel.from_checkpoint_dir(entry["path"], device=device)
