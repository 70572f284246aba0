"""Checkpointing: best-on-val-loss + last + resume, on ``torch.save``
(counterpart of ``multimodal_baby_tpu/train/checkpoint.py``, which writes
orbax directories).

The reference's ModelCheckpoint(monitor="val_loss", save_last=True,
save_top_k=k, filename="{epoch}") and Lightning resume (train.py:84-89,
:107), with the JAX package's layout: under the checkpoint directory,
``last/`` and the top-k ``epoch_N/`` directories, ``index.json`` and the
whole ``ExperimentConfig`` as ``config.json``. Each checkpoint directory
holds one file, ``state.pt``. Every file is written to a temporary path
and then renamed over its target, so a reader never sees half a file.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from multimodal_baby_tpu_torch.core.config import ExperimentConfig

STATE_FILE = "state.pt"


def _write_atomic(path: Path, write) -> None:
    """``write(tmp_path)``, then rename it over ``path``."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def _write_text(path: Path, text: str) -> None:
    _write_atomic(path, lambda tmp: tmp.write_text(text))


def state_file(path) -> Path:
    """The port's state file of the checkpoint directory ``path``; refuses
    one the JAX package's trainer wrote (orbax)."""
    path = Path(path)
    f = path / STATE_FILE
    if not f.exists():
        what = ("an orbax checkpoint, written by the JAX package's trainer"
                if path.is_dir() and any(path.iterdir())
                else "no checkpoint")
        raise ValueError(f"{path} is {what}: the port reads the "
                         f"checkpoints its own trainer writes ({STATE_FILE})")
    return f


class CheckpointManager:
    def __init__(self, directory, save_top_k: int = 1):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self._index_path = self.dir / "index.json"
        self.index: Dict[str, Any] = {"best": [], "last": None}
        if self._index_path.exists():
            self.index = json.loads(self._index_path.read_text())

    def _save_tree(self, name: str, state_tree) -> Path:
        path = self.dir / name
        path.mkdir(exist_ok=True)
        _write_atomic(path / STATE_FILE,
                      lambda tmp: torch.save(state_tree, tmp))
        return path

    def save(self, state_tree, epoch: int, val_loss: float,
             cfg: Optional[ExperimentConfig] = None,
             extra: Optional[dict] = None) -> None:
        """Save `last` every call and `epoch_N` when it enters the top-k
        best by val_loss (lower is better)."""
        if cfg is not None and not (self.dir / "config.json").exists():
            _write_text(self.dir / "config.json", cfg.to_json())

        self._save_tree("last", state_tree)
        self.index["last"] = {"epoch": epoch, "val_loss": val_loss,
                              "extra": extra or {}}

        best: List[dict] = self.index["best"]
        if len(best) < self.save_top_k or \
                val_loss < max(b["val_loss"] for b in best):
            name = f"epoch_{epoch}"
            self._save_tree(name, state_tree)
            best.append({"name": name, "epoch": epoch,
                         "val_loss": val_loss})
            best.sort(key=lambda b: b["val_loss"])
            while len(best) > self.save_top_k:
                drop = best.pop()
                p = self.dir / drop["name"]
                if p.exists():
                    shutil.rmtree(p)
        _write_text(self._index_path, json.dumps(self.index, indent=2))

    def best_path(self) -> Optional[Path]:
        if self.index["best"]:
            return self.dir / self.index["best"][0]["name"]
        return None

    def last_path(self) -> Optional[Path]:
        p = self.dir / "last"
        return p if p.exists() else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the JAX package's
        orbax saves are asynchronous)."""

    def restore(self, path, map_location=None) -> Dict[str, Any]:
        """The state tree saved under the checkpoint directory ``path``
        (a path, or a name under this manager's directory), its tensors on
        ``map_location``."""
        path = Path(path)
        if not path.exists():
            path = self.dir / path
        return torch.load(state_file(path), map_location=map_location,
                          weights_only=True)

    def restore_last(self, map_location=None):
        p = self.last_path()
        if p is None:
            return None, None
        return self.restore(p, map_location), self.index.get("last")

    @staticmethod
    def load_config(ckpt_dir) -> ExperimentConfig:
        return ExperimentConfig.from_json(
            (Path(ckpt_dir) / "config.json").read_text())
