"""The numbers that decide ``correct``: the program's outputs of the timed
path against the plain reference (``benchmark/reference/``), which takes
the same seed and inputs and nothing that the program made.

Training (the check steps of set-up, through the window's own call and
feed): the trunk's features in the first step, as the worst row's
distance to the reference's relative to the reference's norm; each
step's loss, as the largest gap relative to the reference's
loss; the first gradient as the optimizer got it (from its first moment
after one step), and the leaves' change after the check steps, each as
the worst leaf's gap between the program's norm and the reference's,
relative to the larger of that leaf's reference norm and the median
leaf's. Leaves whose reference gradient is under a thousandth of the
median leaf's (the unused LM bias) move by round-off alone and are left
out of the change.

Embedding: every sampled call's rows, the worst row's distance to the
reference's embedding relative to the reference's norm."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import sub_seed
from benchmark.reference import cvcl as ref
from benchmark.reference.adamw import first_moment_to_grad, norm
from benchmark.reference.quant import identity
from benchmark.reference.weights import make_weights

SKIP_BELOW = 1e-3   # of the median leaf's reference gradient norm


def reference_train(cfg: dict, spec, seed: int, batches: Sequence[dict],
                    device, quant: Callable = identity,
                    half_batch: bool = False):
    """(losses, first gradients, leaves after the steps, first trunk
    features, starting weights) of the reference on the check steps'
    batches, from the seed alone."""
    ref.set_precision()
    w = make_weights(spec, sub_seed(seed, "weights"), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "generator"))
    losses, grads, after, feats = ref.train(cfg, w, batches, gen, device,
                                            quant, half_batch)
    return losses, grads, after, feats, w


def rows_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The worst row's distance relative to the reference row's norm; 1.0
    where rows are missing."""
    p, r = p.double().cpu(), r.double().cpu()
    if p.shape != r.shape:
        return 1.0
    return float(((p - r).norm(dim=1) / r.norm(dim=1)).max())


def train_gaps(losses_p: List[float], grads_p: Dict[str, torch.Tensor],
               after_p: Dict[str, torch.Tensor], feats_p: torch.Tensor,
               losses_r: List[float], grads_r: Dict[str, torch.Tensor],
               after_r: Dict[str, torch.Tensor], feats_r: torch.Tensor,
               start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    gp = {n: norm(grads_p[n]) for n in grads_r}
    gr = {n: norm(grads_r[n]) for n in grads_r}
    med_g = statistics.median(gr.values())
    grad_gap = max(abs(gp[n] - gr[n]) / max(gr[n], med_g) for n in gr)
    moved = [n for n in gr if gr[n] >= SKIP_BELOW * med_g]
    cp = {n: norm(after_p[n].to(start[n].device) - start[n]) for n in moved}
    cr = {n: norm(after_r[n] - start[n]) for n in moved}
    med_c = statistics.median(cr.values())
    change_gap = max(abs(cp[n] - cr[n]) / max(cr[n], med_c) for n in moved)
    return {"feature_gap": rows_gap(feats_p, feats_r), "loss_gap": loss_gap,
            "grad_gap": grad_gap, "change_gap": change_gap}


def train(cfg: dict, exp, spec, seed: int, batches: Sequence[dict], device,
          losses_p: List[float], first_moments_p: Dict[str, torch.Tensor],
          after_p: Dict[str, torch.Tensor], feats_p: torch.Tensor
          ) -> Dict[str, float]:
    losses_r, grads_r, after_r, feats_r, start = reference_train(
        cfg, spec, seed, batches, device)
    grads_p = {n: first_moment_to_grad(m, cfg["optimizer"]["betas"][0])
               for n, m in first_moments_p.items()}
    return train_gaps(losses_p, grads_p, after_p, feats_p, losses_r,
                      grads_r, after_r, feats_r, start)


def embed_gap(features_p: np.ndarray, features_r: torch.Tensor) -> float:
    return rows_gap(torch.from_numpy(np.asarray(features_p)), features_r)


def embed(cfg: dict, spec, seed: int, device,
          answers: Sequence[Tuple[np.ndarray, np.ndarray]],
          quant: Callable = identity) -> Dict[str, float]:
    """``answers``: (the call's frames, the program's embeddings)."""
    ref.set_precision()
    w = make_weights(spec, sub_seed(seed, "weights"), device)
    worst = max(embed_gap(out, ref.embed(cfg, w, frames, device, quant))
                for frames, out in answers)
    return {"embed_gap": worst}
