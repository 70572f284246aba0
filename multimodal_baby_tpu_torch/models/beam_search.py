"""Batched beam search (counterpart of
``multimodal_baby_tpu/models/beam_search.py``) as a plain loop: alive and
finished frontiers, 2 x beam candidate expansion, the GNMT length penalty
((5 + len) / 6)^alpha, and the early-stopping bound. Top-k takes the
lower index among equal values, as ``lax.top_k`` does, so the two packages
pick the same candidates on the same logits.

``symbols_to_logits_fn(ids, states) -> (logits, states)`` works on a
flattened [B * W] beam batch; ``states`` is a tuple of tensors with leading
dim B (expanded to B * W here).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

NEG_INF = -1.0e7

States = Optional[Tuple[torch.Tensor, ...]]


def _length_penalty(length: int, alpha: float) -> torch.Tensor:
    return (torch.tensor(5.0 + length, dtype=torch.float32) / 6.0) ** alpha


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_beams(t: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """t: [B, W_in, ...]; indices: [B, W_out] -> [B, W_out, ...]."""
    idx = indices.reshape(indices.shape + (1,) * (t.dim() - 2))
    return t.gather(1, idx.expand(indices.shape + t.shape[2:]))


def beam_search(
    symbols_to_logits_fn: Callable[[torch.Tensor, States],
                                   Tuple[torch.Tensor, States]],
    initial_ids: torch.Tensor, beam_size: int, decode_length: int,
    vocab_size: int, alpha: float = 0.0, states: States = None,
    eos_id: int = 3, stop_early: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (seq [B, W, decode_length + 1], scores [B, W]) sorted best
    first; scores are length-penalised log probabilities (raw alive log
    probabilities for a row that finished no hypothesis)."""
    B, W = initial_ids.shape[0], beam_size
    T = decode_length + 1
    device = initial_ids.device
    alive_seq = torch.zeros((B, W, T), dtype=torch.long, device=device)
    alive_seq[:, :, 0] = initial_ids[:, None]
    alive_lp = torch.tensor([[0.0] + [NEG_INF] * (W - 1)],
                            device=device).repeat(B, 1)
    if states is not None:
        states = tuple(s.repeat_interleave(W, dim=0) for s in states)
    f_seq = torch.zeros((B, W, T), dtype=torch.long, device=device)
    f_scores = torch.full((B, W), NEG_INF, device=device)
    f_flags = torch.zeros((B, W), dtype=torch.bool, device=device)
    max_pen = (_length_penalty(decode_length, alpha).to(device)
               if alpha > 0.0 else 1.0)

    for i in range(decode_length):
        # stop once no alive beam can beat the finished bound
        alive_bound = alive_lp[:, 0] / max_pen
        finished_bound = (f_scores.max(dim=1).values if stop_early
                          else f_scores.min().expand(B))
        if bool((finished_bound > alive_bound).all()):
            break
        ids = alive_seq[:, :, i].reshape(B * W)
        logits, new_states = symbols_to_logits_fn(ids, states)
        log_probs = torch.log_softmax(logits.float(), dim=-1).reshape(
            B, W, vocab_size)
        cand = (alive_lp[:, :, None] + log_probs).reshape(B, W * vocab_size)
        topk_lp, topk_idx = _top_k(cand, 2 * W)
        topk_beam = topk_idx // vocab_size
        topk_id = topk_idx % vocab_size
        seq = _gather_beams(alive_seq, topk_beam)
        seq[:, :, i + 1] = topk_id
        is_eos = topk_id == eos_id

        # the new alive frontier: the best W candidates that did not end
        alive_lp, alive_sel = _top_k(
            torch.where(is_eos, NEG_INF, topk_lp), W)
        alive_seq = _gather_beams(seq, alive_sel)
        orig_beam = topk_beam.gather(1, alive_sel)
        if new_states is not None:
            new_states = tuple(
                _gather_beams(s.reshape((B, W) + s.shape[1:]), orig_beam)
                .reshape(s.shape) for s in new_states)
        states = new_states

        # the new finished frontier: EOS candidates, length-penalised by
        # the number of generated tokens
        pen = _length_penalty(i + 1, alpha).to(device)
        fin_scores = torch.where(is_eos, topk_lp / pen, NEG_INF)
        all_scores = torch.cat([f_scores, fin_scores], dim=1)
        all_seq = torch.cat([f_seq, seq], dim=1)
        all_flags = torch.cat([f_flags, is_eos & (fin_scores > NEG_INF / 2)],
                              dim=1)
        f_scores, f_sel = _top_k(all_scores, W)
        f_seq = _gather_beams(all_seq, f_sel)
        f_flags = all_flags.gather(1, f_sel)

    # rows with no finished hypothesis return their alive beams
    any_finished = f_flags.any(dim=1)
    seq = torch.where(any_finished[:, None, None], f_seq, alive_seq)
    scores = torch.where(any_finished[:, None], f_scores, alive_lp)
    return seq, scores
