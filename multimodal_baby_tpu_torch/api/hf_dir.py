"""A Hugging Face model directory, read by the port itself: the JAX package
reads one through ``transformers.from_pretrained``, which the port does not
import (nor ``safetensors`` or ``huggingface_hub``), and the card's machine
has none of them.

    model_dir = resolve_model_dir("openai/clip-vit-large-patch14")
    config = read_config(model_dir)
    state = read_state_dict(model_dir)   # name -> numpy array

A name resolves to a local directory, or to a snapshot in the Hugging Face
cache as ``from_pretrained`` resolves a name offline:
``<cache>/models--<org>--<name>/snapshots/<refs/main>/``, where ``<cache>``
is ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``.
Anything else is refused with a message: the port never opens a
connection.

The weights are ``model.safetensors`` (parsed here: an 8-byte
little-endian header length, a JSON header, then the tensors' raw
little-endian bytes; F32, F16, BF16 and I64) or ``pytorch_model.bin``
(``torch.load`` with ``weights_only=True``). Floating tensors come back as
f32 (f16 and bf16 are widened), integer ones as they are.
``write_safetensors`` writes the same format.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch

SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"
# safetensors dtype -> the little-endian numpy dtype its bytes are read as
_READ = {"F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8"}
_WRITE = {np.dtype(v): k for k, v in _READ.items() if k != "BF16"}


def hub_cache() -> Path:
    """The Hugging Face hub cache that ``from_pretrained`` reads."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"]).expanduser()
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]).expanduser() / "hub"
    xdg = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(xdg).expanduser() / "huggingface" / "hub"


def cache_snapshot(name: str) -> Path:
    """Where the cache keeps ``name``'s snapshot of ``refs/main`` (it may
    not exist)."""
    repo = hub_cache() / ("models--" + name.replace("/", "--"))
    ref = repo / "refs" / "main"
    rev = ref.read_text().strip() if ref.is_file() else "<refs/main>"
    return repo / "snapshots" / rev


def resolve_model_dir(name: Union[str, Path]) -> Path:
    """A local directory, or the cache's snapshot of the model ``name``;
    raises FileNotFoundError otherwise."""
    path = Path(name).expanduser()
    if path.is_dir():
        return path
    snapshot = cache_snapshot(str(name))
    if (snapshot / "config.json").is_file():
        return snapshot
    raise FileNotFoundError(
        f"{str(name)!r} is neither a local directory nor in the Hugging "
        f"Face cache ({snapshot} has no config.json). The port does not "
        f"download: put the model's config.json, {SAFETENSORS} or "
        f"{TORCH_BIN}, vocab.json and merges.txt in a directory and pass "
        f"its path, or set HF_HOME to a cache that holds it")


def read_config(model_dir: Union[str, Path]) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file, floats as f32 (F32 tensors
    are views of a read-only memory map of the file)."""
    path = Path(path)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if data.size < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    n = int(data[:8].view("<u8")[0])
    if 8 + n > data.size:
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    header.pop("__metadata__", None)
    body = data[8 + n:]
    out = {}
    for name, info in header.items():
        kind = info["dtype"]
        if kind not in _READ:
            raise ValueError(f"{path}: tensor {name!r} has dtype {kind}, "
                             f"which the reader does not know")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dt = np.dtype(_READ[kind])
        if not 0 <= begin <= end <= body.size \
                or end - begin != dt.itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{begin, end} for {kind} {list(shape)}")
        a = body[begin:end].view(dt).reshape(shape)
        if kind == "BF16":   # the high half of an f32
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32) if kind == "F16" else a
    return out


def write_safetensors(path: Union[str, Path],
                      tensors: Mapping[str, Union[np.ndarray, torch.Tensor]]
                      ) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors, each f32, f16,
    bf16 (torch only) or int64, little-endian) as one ``.safetensors``
    file, one tensor at a time."""
    entries, offset = [], 0
    for name, t in tensors.items():
        bf16 = isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            t = (t.view(torch.int16) if bf16 else t).numpy()
        raw = np.ascontiguousarray(t)
        kind = "BF16" if bf16 else _WRITE[raw.dtype]
        entries.append((name, kind, list(raw.shape), raw, offset))
        offset += raw.nbytes
    header = {name: {"dtype": kind, "shape": shape,
                     "data_offsets": [begin, begin + raw.nbytes]}
              for name, kind, shape, raw, begin in entries}
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for *_, raw, _ in entries:
            f.write(raw.tobytes())


def read_torch_bin(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Every tensor of a ``pytorch_model.bin`` (``torch.load`` with
    ``weights_only=True``), floats as f32."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {name: (t.float() if t.is_floating_point() else t).numpy()
            for name, t in state.items()}


def read_state_dict(model_dir: Union[str, Path]) -> Dict[str, np.ndarray]:
    """The model's weights: ``model.safetensors``, else
    ``pytorch_model.bin``."""
    model_dir = Path(model_dir)
    if (model_dir / SAFETENSORS).is_file():
        return read_safetensors(model_dir / SAFETENSORS)
    if (model_dir / TORCH_BIN).is_file():
        return read_torch_bin(model_dir / TORCH_BIN)
    raise FileNotFoundError(f"{model_dir}: no {SAFETENSORS} or {TORCH_BIN}")
