"""The (data, model) mesh on ``torch.distributed`` (counterpart of
``multimodal_baby_tpu/parallel/mesh.py``).

- ``data`` axis: each rank holds its rows of the global batch; the
  InfoNCE gathers the features over the data group for the global-batch
  negatives, and the gradients of the replicated parameters are averaged
  over it (``parallel/collectives.py``).
- ``model`` axis: the vocab-sharded token embedding and tied LM head
  (``models/text.py``, ``models/multimodal.py``): each model rank holds a
  contiguous slice of the vocab rows.

Ranks are laid out data-major, as the JAX package's
``devices.reshape(d, m)``: rank ``r`` sits at data coordinate ``r // m``
and model coordinate ``r % m``; its data group is the ranks of its model
coordinate, its model group those of its data coordinate. The groups come
from a ``DeviceMesh`` named ``("data", "model")`` when a process group is
initialised; a world of one without one is a mesh of no groups, on which
every collective is the identity.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_baby_tpu_torch.core.constants import DATA_AXIS, MODEL_AXIS


class Mesh:
    """``shape`` {"data": d, "model": m}, this process's ``rank`` and the
    ``DeviceMesh`` (None for a world of one without a process group)."""

    def __init__(self, d: int, m: int, rank: int = 0, device_mesh=None):
        self.shape: Dict[str, int] = {DATA_AXIS: d, MODEL_AXIS: m}
        self.rank = rank
        self.device_mesh = device_mesh

    def coordinate(self, axis: str) -> int:
        m = self.shape[MODEL_AXIS]
        return self.rank // m if axis == DATA_AXIS else self.rank % m

    def group(self, axis: str):
        """The process group along ``axis`` holding this rank (a group of
        one where the axis has one rank), or None without a process group
        (every collective the identity)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, rank={self.rank})")


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_device(device) -> torch.device:
    """``device`` for this process: a bare "cuda" under a process group is
    ``cuda:{LOCAL_RANK}`` (torchrun's), made the current device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and dist.is_available() and dist.is_initialized():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def create_mesh(mesh_shape: Tuple[int, int] = (-1, 1),
                device_type: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the process group's ranks. ``-1`` in
    either coordinate means "all remaining ranks". ``device_type`` is the
    DeviceMesh's ("cuda" under nccl, "cpu" under gloo; by default from the
    backend)."""
    n, rank = world()
    d, m = mesh_shape
    if d == -1 and m == -1:
        raise ValueError("at most one mesh axis may be -1")
    if d == -1:
        d = n // m
    if m == -1:
        m = n // d
    if d * m != n:
        raise ValueError(f"mesh shape {(d, m)} does not cover {n} devices")
    if n == 1 and not dist.is_initialized():
        return Mesh(1, 1)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(device_type, (d, m),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(d, m, rank, device_mesh)


def padded_rows(n: int, d: int, pad_to: Optional[int] = None
                ) -> np.ndarray:
    """The row order of a global batch of ``n`` on ``d`` data shards: the
    rows as they are when ``d`` divides ``n``, else padded with
    wrap-around rows up to ``pad_to`` (when it is a multiple of ``d`` not
    under ``n``) or the next multiple of ``d`` (``mesh.py:75-82``)."""
    if n % d == 0:
        return np.arange(n)
    target = pad_to if pad_to and pad_to >= n and pad_to % d == 0 \
        else -(-n // d) * d
    return np.concatenate([np.arange(n), np.arange(target - n) % n])


def local_rows(mesh: Mesh, n: int, pad_to: Optional[int] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(rows, valid): the rows of a global batch of ``n`` that this rank
    holds (indices into the unpadded batch), and their boolean ``valid``
    mask when the batch is padded (None when it is not). Ranks of one data
    group, across the model axis, hold the same rows."""
    d = mesh.shape[DATA_AXIS]
    order = padded_rows(n, d, pad_to)
    per = len(order) // d
    lo = mesh.coordinate(DATA_AXIS) * per
    valid = None
    if len(order) != n:
        valid = np.arange(lo, lo + per) < n
    return order[lo:lo + per], valid


def shard_batch(mesh: Mesh, batch: Mapping[str, object],
                pad_to: Optional[int] = None) -> Dict[str, object]:
    """This rank's rows of a host batch (a dict of arrays or lists, the
    leading axis the batch): a ragged tail (rows not divisible by the data
    axis) is padded with wrap-around rows up to ``pad_to`` or the next
    data-axis multiple, and a boolean ``valid`` row mask is added, as the
    JAX package's ``shard_batch``; the loss and metrics mask the padding
    out exactly. The arrays stay on the host (``train/step.py::
    device_batch`` copies them)."""
    n = len(next(iter(batch.values())))
    rows, valid = local_rows(mesh, n, pad_to)
    out = {k: ([v[int(i)] for i in rows] if isinstance(v, list)
               else np.asarray(v)[rows]) for k, v in batch.items()}
    if valid is not None:
        out["valid"] = valid
    return out


def param_pspec(name: str, param: torch.Tensor) -> Tuple:
    """The partition spec of a parameter: ``(MODEL_AXIS, None)`` for the
    2-D token embedding (its vocab rows split over the model axis), else
    ``()`` (replicated). The tied LM head reads the same table; its bias
    stays replicated, as in the JAX package."""
    if "embedding" in name.split(".")[-2:-1] and param.dim() == 2:
        return (MODEL_AXIS, None)
    return ()


def make_param_shardings(mesh: Mesh, model: torch.nn.Module
                         ) -> Dict[str, Tuple]:
    """{parameter name: partition spec} (all replicated when the model
    axis has one rank)."""
    if mesh.shape[MODEL_AXIS] == 1:
        return {name: () for name, _ in model.named_parameters()}
    return {name: param_pspec(name, p)
            for name, p in model.named_parameters()}
