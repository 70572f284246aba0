"""CLIP ViT-L/14 trained contrastively end to end (Radford et al. 2021,
Tables 19-20; openai/clip-vit-large-patch14's config.json; OpenCLIP's
ViT-L-14.json), float32 with TF32 off, under the program's names: the
vision tower (``vision_encoder.model.*``: a bias-free patch convolution, a
class embedding, learned positions, ``pre_layrnorm``, pre-norm blocks with
a QuickGELU MLP, ``post_layernorm`` of the class token, the bias-free
visual projection ``head``), the text tower (``reference/text_clip.py``,
``text_encoder.*``) and the learned logit scale
(``model.logit_neg_log_temperature``, its log).

A train step: the configuration's augment (``reference/augment.py``),
both towers, L2-normalised features, the symmetric InfoNCE over the
batch's logits at the learned scale, every leaf's gradient, then AdamW
with the configuration's betas and eps, the weight decay on the leaves of
two or more axes only (OpenCLIP: not on gains, biases, the class
embedding or the logit scale), and the log scale clipped to [0, ln 100]
after the update.

The mathematics is the whole batch's; to fit at the card's batch the
towers run in blocks of rows: every row's features first without a
gradient, the loss's gradient with respect to them, then each block of
rows again with a gradient, taking the loss's gradient for its rows
backward through the tower. ``quant`` rounds both operands of the
augment's products, the patch convolution, every Dense and the
projections (the control's fp8); the gradient passes each rounding as it
is, in float32 (rounding it too would flush the leaves' small gradients
to zero in fp8, a fault of the control rather than of its precision).

The widths are ViT-L/14's (``WIDTHS``) unless the configuration's
``sizes`` say otherwise (the tests' tiny size). ``spec``, ``forward``,
``OUT_DIM`` and ``HEAD`` are the trunk's parts by the names that
``reference/cvcl.py`` finds; CLIP's whole model is ``model_spec``: CVCL's
composition would add a head bias and an LM bias that CLIP has not."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import adamw, augment, infonce, text_clip
from benchmark.reference.quant import identity
from benchmark.reference.weights import Spec, make_weights

# openai/clip-vit-large-patch14's vision_config
WIDTHS = {"patch": 14, "width": 1024, "layers": 24, "heads": 16,
          "mlp_dim": 4096, "ln_eps": 1e-5}
OUT_DIM = WIDTHS["width"]
HEAD = "head"   # the visual projection: <prefix>head.weight, no bias
TRUNK_PREFIX = "vision_encoder.model."
TEXT_PREFIX = "text_encoder."
LOG_SCALE = "model.logit_neg_log_temperature"
MAX_LOG_SCALE = math.log(100.0)
ROWS = 16   # rows a tower runs at once with a gradient (≈ 12 GB at L/14)


def spec(prefix: str, px: int = 224, s: Optional[Dict] = None) -> Spec:
    """The vision tower's leaves but the head: the patch convolution
    U(-k, k), k = 1 / sqrt(3 P^2); the class embedding and positions
    N(0, 0.02^2); the LayerNorms 1 + 0.1 N and 0.1 N; the blocks as
    ``text_clip.block_spec``."""
    s = s or WIDTHS
    c, patch = s["width"], s["patch"]
    tokens = (px // patch) ** 2 + 1
    out: Spec = [
        (f"{prefix}patch_embedding.weight", (c, 3, patch, patch),
         ("uniform", 1.0 / math.sqrt(3 * patch * patch))),
        (f"{prefix}class_embedding", (c,), ("normal", 0.02)),
        (f"{prefix}position_embedding.weight", (tokens, c),
         ("normal", 0.02)),
        (f"{prefix}pre_layrnorm.weight", (c,), ("scale",)),
        (f"{prefix}pre_layrnorm.bias", (c,), ("shift",)),
    ]
    for i in range(s["layers"]):
        out += text_clip.block_spec(f"{prefix}blocks.{i}.", c, s["mlp_dim"])
    out += [(f"{prefix}post_layernorm.weight", (c,), ("scale",)),
            (f"{prefix}post_layernorm.bias", (c,), ("shift",))]
    return out


def model_spec(cfg: dict) -> Spec:
    """Every leaf of the configuration but the logit scale, which
    ``initial_weights`` adds; the head U(-k, k), k = 1 / sqrt(width)."""
    s = cfg["sizes"]
    c = s["width"]
    return (spec(TRUNK_PREFIX, s["image_px"], s)
            + [(f"{TRUNK_PREFIX}{HEAD}.weight", (s["embedding_dim"], c),
                ("uniform", 1.0 / math.sqrt(c)))]
            + text_clip.spec(TEXT_PREFIX, s["vocab_size"],
                             s["embedding_dim"], s["max_len"], s))


def initial_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from the seed (``weights.make_weights``), and the log
    logit scale at ln(1 / temperature)."""
    w = make_weights(model_spec(cfg), seed, device)
    w[LOG_SCALE] = torch.tensor(
        -math.log(cfg["experiment"]["model"]["temperature"]), device=device)
    return w


def decayed(name: str, w: Dict[str, torch.Tensor]) -> bool:
    """OpenCLIP's rule: the leaves of two or more axes."""
    return w[name].dim() >= 2


def forward(w: Dict[str, torch.Tensor], x_nhwc: torch.Tensor,
            batch_stats: bool = False, prefix: str = "",
            quant: Callable = identity, s: Optional[Dict] = None
            ) -> torch.Tensor:
    """Normalised frames [B, S, S, 3] -> ``post_layernorm`` of the class
    token, [B, width] (``batch_stats`` is unused: no BatchNorm)."""
    s = s or WIDTHS
    eps = s["ln_eps"]
    x = x_nhwc.permute(0, 3, 1, 2)
    patches = F.conv2d(quant(x), quant(w[f"{prefix}patch_embedding.weight"]),
                       stride=s["patch"])
    B, C = patches.shape[:2]
    t = torch.cat([w[f"{prefix}class_embedding"].expand(B, 1, C),
                   patches.flatten(2).transpose(1, 2)], dim=1)
    t = t + w[f"{prefix}position_embedding.weight"]
    t = F.layer_norm(t, (C,), w[f"{prefix}pre_layrnorm.weight"],
                     w[f"{prefix}pre_layrnorm.bias"], eps)
    for i in range(s["layers"]):
        t = text_clip.block(w, t, f"{prefix}blocks.{i}.", s["heads"], eps,
                            False, quant)
    return F.layer_norm(t[:, 0], (C,), w[f"{prefix}post_layernorm.weight"],
                        w[f"{prefix}post_layernorm.bias"], eps)


def straight_through(quant: Callable) -> Callable:
    """``quant`` in the forward, the identity in the backward."""
    if quant is identity:
        return identity
    return lambda x: x + (quant(x) - x).detach()


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _in_rows(fn: Callable, x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def train(cfg: dict, w: Dict[str, torch.Tensor], batches: Sequence[dict],
          gen: torch.Generator, device, quant: Callable = identity,
          half_batch: bool = False
          ) -> Tuple[List[float], Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor], torch.Tensor]:
    """Train steps on the host ``batches`` (``image_u8``, ``text``), the
    augment drawn from ``gen``. Returns (each step's loss, the first
    step's gradient of every leaf, every leaf after the last step, the
    first step's vision features). ``half_batch`` (a fault to read) leaves
    out the second half of each batch and takes the loss's mean over the
    rest."""
    s = cfg["sizes"]
    opt = cfg["optimizer"]
    betas = tuple(opt["betas"])
    quant = straight_through(quant)
    params = {n: t.clone() for n, t in w.items()}
    groups = [(opt["weight_decay"], {n: p for n, p in params.items()
                                     if decayed(n, params)}),
              (0.0, {n: p for n, p in params.items()
                     if not decayed(n, params)})]
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    head = f"{TRUNK_PREFIX}{HEAD}.weight"
    losses, first, trunk_first = [], {}, None
    for t, b in enumerate(batches, start=1):
        frames = torch.from_numpy(b["image_u8"]).to(device)
        B, H, W_, _ = frames.shape
        x = augment.apply(frames, augment.sample(B, H, W_, gen, device),
                          s["image_px"], quant)
        ids = torch.from_numpy(b["text"].astype(np.int64)).to(device)
        live = {n: p.detach().requires_grad_(True) for n, p in params.items()}

        def vision(xs):
            return forward(live, xs, False, TRUNK_PREFIX, quant, s)

        def text(xs):
            return text_clip.pooled(live, xs, TEXT_PREFIX, s, quant)

        with torch.no_grad():
            pv = _in_rows(vision, x, 4 * ROWS).requires_grad_(True)
            pt = _in_rows(text, ids, 4 * ROWS).requires_grad_(True)
        fi = _normalise(F.linear(quant(pv), quant(live[head])))
        ft = _normalise(text_clip.project(live, pt, TEXT_PREFIX, quant))
        logits = fi @ ft.T * live[LOG_SCALE].exp()
        if half_batch:
            logits = logits[:B // 2, :B // 2]
        loss = infonce.loss(logits)
        loss.backward()
        for fn, inp, feats in ((vision, x, pv), (text, ids, pt)):
            for i in range(0, B, ROWS):
                fn(inp[i:i + ROWS]).backward(feats.grad[i:i + ROWS])
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for n, p in live.items()}
        if t == 1:
            first = {n: g.clone() for n, g in grads.items()}
            trunk_first = pv.detach()
        for wd, group in groups:
            adamw.step(group, grads, state, t, opt["lr"], wd, betas,
                       opt["eps"])
        params[LOG_SCALE].clamp_(0.0, MAX_LOG_SCALE)
        losses.append(float(loss.detach()))
    return losses, first, params, trunk_first
