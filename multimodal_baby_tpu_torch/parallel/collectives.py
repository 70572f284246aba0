"""Collectives with gradients, and the gradient reduction of the train step.

Two conventions, one per mesh axis:

- **data group**: the loss is computed replicated on every rank from
  gathered or summed quantities. The backward of ``all_gather`` is a
  reduce-scatter of the sum, that of ``all_reduce`` an all-reduce of the
  sum: each rank's local tensors receive the gradients of every rank's
  (identical) loss, d times the gradient of the one global loss. The
  step's ``reduce_gradients`` then *averages* the parameter gradients
  over the data group, which gives every rank the gradient of the world-1
  step on the global batch. A parameter used only after a gather (the
  temperature) has the same whole gradient on every rank, which the
  average keeps.
- **model group** (the vocab-parallel embedding and LM head; Megatron's
  conjugate pairs): the computation after the embedding's all-reduce, and
  after the logits' gather, is replicated over the model group, so
  ``model_reduce`` (all-reduce forward) passes its gradient through as it
  is, ``model_copy`` (identity forward) all-reduces its input's
  gradient, and ``model_gather`` (gather along the last axis) hands each
  rank its own slice of the gradient.

Each function is the identity when its group is None (no process
group).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

# torch 2.10+ names; earlier releases have only the *_tensor forms
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        out = grad.new_empty((grad.shape[0] // n,) + tuple(grad.shape[1:]))
        _reduce_scatter_single(out, grad.contiguous(), group=ctx.group)
        return out, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along axis 0 in rank order;
    backward: the reduce-scatter of the sum (data-group convention). A
    tensor without gradient (token lengths, the valid mask) is gathered
    without autograd."""
    if group is None:
        return x
    if not x.requires_grad:
        if x.dtype == torch.bool:
            return _gather0(x.to(torch.uint8), group).bool()
        return _gather0(x, group)
    return _AllGather.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``; backward: the all-reduce of the sum
    (data-group convention)."""
    if group is None:
        return x
    if not x.requires_grad:
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x
    return _AllReduce.apply(x, group)


class _ModelReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        return _gather0(x.movedim(-1, 0), group).movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def model_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over the model group; the gradient passes
    through."""
    return x if group is None else _ModelReduce.apply(x, group)


def model_copy(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the gradient is all-reduced over the model group."""
    return x if group is None else _ModelCopy.apply(x, group)


def model_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate the model group's ``x`` along the last axis in rank
    order; the gradient of each rank's own slice comes back."""
    return x if group is None else _ModelGather.apply(x, group)


def reduce_gradients(params: Iterable[torch.Tensor], group,
                     size: int) -> None:
    """Average the ``.grad`` of ``params`` over ``group`` (``size``
    ranks), in one all-reduce of a flat buffer (a parameter without a
    gradient is skipped; the step zero-fills them first)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (the identity without a
    process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
