"""The vocab-sharded token embedding: each model rank holds a contiguous
slice of the vocab rows (the JAX package's ``P("model", None)`` on the
token embedding, ``parallel/mesh.py::param_pspec``).

A vocab of V rows on m ranks gives each rank ceil(V / m) rows; the last
rank's slice is padded with zero rows past V (2350 on 4 ranks: 588 rows
each, two padded). No id reaches a padded row, and the tied LM head drops
their logits before the softmax, so they never win a lookup or a softmax.

``shard_vocab`` turns a model's full table into its rank's slice (before
the optimizer is built). A checkpoint holds the full table and the full
optimizer moments: ``full_model_state`` / ``full_optimizer_state`` gather
them (collectives: every rank calls them), ``load_full_model_state`` /
``load_full_optimizer_state`` slice them again, so a checkpoint is the
same file at any mesh shape and resumes at any other. ``unsharded`` gives
a model its full table for what runs on one rank (forced choice, text
generation).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from multimodal_baby_tpu_torch.core.constants import MODEL_AXIS, PAD_TOKEN_ID
from multimodal_baby_tpu_torch.parallel.collectives import (
    _gather0, model_reduce)
from multimodal_baby_tpu_torch.parallel.mesh import Mesh

EMBEDDING = "text_encoder.embedding.weight"


class VocabShard:
    """This model rank's rows ``[start, start + rows)`` of a vocab of
    ``vocab_size`` over ``size`` ranks of ``group``."""

    def __init__(self, vocab_size: int, group, rank: int, size: int):
        self.vocab_size = vocab_size
        self.group = group
        self.size = size
        self.rows = -(-vocab_size // size)
        self.start = rank * self.rows

    def slice(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full ``[V, ...]`` tensor, zero-padded."""
        pad = self.rows * self.size - full.shape[0]
        if pad:
            full = torch.cat([full, full.new_zeros((pad,) + full.shape[1:])])
        return full[self.start:self.start + self.rows].clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full ``[V, ...]`` tensor from every rank's slice (no
        gradient)."""
        return _gather0(local.detach(), self.group)[:self.vocab_size]


def embed(table: torch.Tensor, ids: torch.Tensor, shard: VocabShard
          ) -> torch.Tensor:
    """The lookup of ``ids`` in the sharded ``table``: each rank looks up
    the ids of its slice (the others zero), then a sum over the model
    group. PAD's lookups pass no gradient to its row, as
    ``padding_safe_embed`` (the PAD row is rank 0's local row 0)."""
    local = ids - shard.start
    inside = (local >= 0) & (local < shard.rows)
    out = F.embedding(torch.where(inside, local, 0), table,
                      padding_idx=PAD_TOKEN_ID if shard.start == 0 else None)
    out = torch.where(inside[..., None], out, 0.0)
    return model_reduce(out, shard.group)


def shard_vocab(model: torch.nn.Module, mesh: Mesh) -> Optional[VocabShard]:
    """Replace ``model``'s token embedding by this rank's slice and set
    its text encoder's ``vocab_shard`` (nothing when the model axis has
    one rank). Call before the optimizer is built."""
    m = mesh.shape[MODEL_AXIS]
    if m == 1:
        return None
    enc = model.text_encoder
    shard = VocabShard(model.cfg.vocab_size, mesh.group(MODEL_AXIS),
                       mesh.coordinate(MODEL_AXIS), m)
    full = enc.embedding.weight.detach()
    enc.embedding.weight = torch.nn.Parameter(shard.slice(full))
    enc.vocab_shard = shard
    return shard


def _shard_of(model) -> Optional[VocabShard]:
    return getattr(model.text_encoder, "vocab_shard", None)


def full_model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the full token embedding (gathered over
    the model group when sharded: every rank calls it)."""
    sd = model.state_dict()
    shard = _shard_of(model)
    if shard is not None:
        sd[EMBEDDING] = shard.gather(sd[EMBEDDING])
    return sd


def load_full_model_state(model: torch.nn.Module,
                          sd: Dict[str, torch.Tensor]) -> None:
    """Load a full state dict (any mesh shape's checkpoint), slicing the
    token embedding when ``model``'s is sharded."""
    shard = _shard_of(model)
    if shard is not None:
        sd = dict(sd)
        sd[EMBEDDING] = shard.slice(sd[EMBEDDING])
    model.load_state_dict(sd)


def _embedding_index(optimizer, model) -> Optional[int]:
    weight = model.text_encoder.embedding.weight
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        if p is weight:
            return i
    return None


def _map_embedding_state(optimizer, model, sd, fn):
    """``sd`` (an optimizer state dict) with ``fn`` applied to every
    tensor of the embedding's state shaped like the embedding (Adam's
    moments, SGD's momentum)."""
    shard = _shard_of(model)
    i = _embedding_index(optimizer, model)
    if shard is None or i is None or i not in sd["state"]:
        return sd
    state = dict(sd["state"])
    state[i] = {k: (fn(shard, v) if torch.is_tensor(v) and v.dim() == 2
                    else v) for k, v in state[i].items()}
    return {**sd, "state": state}


def full_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` with the embedding's moments gathered
    (every rank calls it)."""
    return _map_embedding_state(optimizer, model, optimizer.state_dict(),
                                lambda s, v: s.gather(v))


def load_full_optimizer_state(optimizer, model, sd: dict) -> None:
    """Load a full optimizer state dict, slicing the embedding's moments
    when the embedding is sharded."""
    optimizer.load_state_dict(_map_embedding_state(
        optimizer, model, sd, lambda s, v: s.slice(v)))


@contextlib.contextmanager
def unsharded(model: torch.nn.Module, on_this_rank: bool = True):
    """Inside, ``model`` has its full token embedding and no vocab shard
    (for work that runs on one rank). The gather is a collective: every
    rank of the model group enters; only where ``on_this_rank`` is the
    table swapped in. Nothing happens for an unsharded model."""
    shard = _shard_of(model)
    if shard is None:
        yield model
        return
    enc = model.text_encoder
    full = shard.gather(enc.embedding.weight)
    if not on_this_rank:
        yield model
        return
    local = enc.embedding.weight.data
    enc.embedding.weight.data = full
    enc.vocab_shard = None
    try:
        yield model
    finally:
        enc.embedding.weight.data = local
        enc.vocab_shard = shard
