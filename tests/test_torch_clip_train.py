"""CVCL with CLIP's parts trained through the port's train step
(``VisionConfig(cnn_model="clip_vit_l14")``: CLIP's vision tower as the
trunk, K5 and K6 in bf16 with their gradient through ``PlainVJP``; the
text encoder "clip"; CLIP's AdamW and logit-scale clip), held to the
benchmark's plain float32 reference (``benchmark/reference/
clip_vit_l14.py``, ``text_clip.py``) on the CPU at a tiny size with
seeded weights: the loss and every leaf's gradient, the leaves after two
AdamW steps, the clip of the logit scale. Each comparison is also run
with the trunk frozen or the decay on every leaf, and must then fail.
The trunk's backward records its ``mmb/vjp/*`` spans under
``mmb/backward``. The eval-only ``CLIPModel`` of the CLIP baseline gives
what its forward gave before the towers could train.

The tiny size keeps the kernels' shape gates open, so the bf16 path runs
K5's and K6's plain versions and their ``PlainVJP`` as the card runs the
kernels: vision width 128 in 2 heads of 64 (K5 takes heads of 64), MLP
512 (K6 takes multiples of 512), 2 blocks, 32 px frames in patches of 8;
text width 64 in 4 heads, MLP 256, 2 blocks, 16 positions, vocabulary
128; embeddings of 64."""

import copy
import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import sub_seed
from benchmark.loops import clip_train
from benchmark.reference import clip_vit_l14 as ref
from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.models import clip as tclip
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.vision_vit import per_weight_state
from multimodal_baby_tpu_torch.ops import vit_common
from multimodal_baby_tpu_torch.ops.vit_common import gelu
from multimodal_baby_tpu_torch.train import profiler
from multimodal_baby_tpu_torch.train import step as train_step
from multimodal_baby_tpu_torch.train.optimizer import (
    build_optimizer, parse_optimizer)
from multimodal_baby_tpu_torch.train.profiler import SpanStore
from multimodal_baby_tpu_torch.train.step import (
    device_batch, init_train_state, make_train_step)

CONFIG = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
          / "clip_vit_l14.json")
PX, B, SEED = 32, 8, 2 ** 31 + 26
SIZES = dict(image_px=PX, patch=8, width=128, layers=2, heads=2,
             mlp_dim=512, text_width=64, text_layers=2, text_heads=4,
             text_mlp_dim=256, max_len=16, vocab_size=128,
             embedding_dim=64)
TINY_CLIP = {
    "projection_dim": 64,
    "max_logit_scale": 100.0,
    "text_config": dict(hidden_size=64, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=16, vocab_size=128,
                        eos_token_id=2),
    "vision_config": dict(hidden_size=128, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=PX, patch_size=8)}
EVERY_LEAF = "AdamW:beta2=0.98,eps=1e-6"   # CLIP's AdamW, decay on all

# Tolerances, each a leaf's error norm over its reference norm (or the
# loss's relative error). f32: the port's LayerNorm takes the variance as
# E[x^2] - mean^2 and the reference two-pass, and the products sum in
# other orders: about 1e-6 of a leaf, so 1e-4 leaves room and still
# catches a leaf that is frozen (1.0) or decayed when it should not be
# (2e-1 of its change). bf16: the kernels' rounding points (operands,
# LayerNorm outputs, probabilities and residual sums rounded to 8 bits of
# mantissa, 4e-3 a rounding) over 2 blocks a tower give a few 1e-2 of a
# leaf's gradient; 0.1 is under a tenth of what a frozen trunk reads.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}
CHANGE_TOL = 1e-3   # f32: a decayed gain moves 2e-1 of its change off


def reference_augment(images, out_size=PX, augment=True,
                      dtype=torch.float32, generator=None, **_):
    """The train step's augment replaced by the reference's, from the same
    generator: both sides see the same frames (the port's augment keeps
    its own tests; it differs from the reference by ~1e-2 of a frame)."""
    d = ref.augment.sample(*images.shape[:3], generator, images.device)
    return ref.augment.apply(images, d, out_size).to(dtype)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """The program's ViT-L/14 at the tiny size, the reference's augment at
    32 px, one thread (beside the other test workers)."""
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "clip_vit_l14", TINY_CLIP)
    monkeypatch.setattr(train_step, "augment_batch", reference_augment)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(optimizer=None):
    cfg = json.loads(CONFIG.read_text())
    cfg["sizes"].update(SIZES)
    m = cfg["experiment"]["model"]
    m.update(vocab_size=SIZES["vocab_size"],
             embedding_dim=SIZES["embedding_dim"])
    t = cfg["experiment"]["train"]
    t.update(lr=cfg["optimizer"]["lr"],
             weight_decay=cfg["optimizer"]["weight_decay"],
             seed=sub_seed(SEED, "generator"))
    if optimizer:
        t["optimizer"] = optimizer
    return cfg


def batches(cfg, n=2):
    tr = {"batch": B, "frame_px": PX, "pool_batches": n,
          "caption_tokens": [3, 13]}
    return clip_train.train_pool(cfg, tr, SEED, "cpu")


def build(cfg, dtype, frozen=False, log_scale=None):
    """(model, train state, train step) of the port on the seed's
    weights."""
    d = copy.deepcopy(cfg["experiment"])
    d["model"]["vision"]["finetune_cnn"] = not frozen
    d["parallel"]["compute_dtype"] = str(dtype).split(".")[1]
    exp = ExperimentConfig.from_dict(d)
    weights = ref.initial_weights(cfg, sub_seed(SEED, "weights"), "cpu")
    if log_scale is not None:
        weights[ref.LOG_SCALE].fill_(log_scale)
    model = CVCL(exp.model, dtype=dtype, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model, init_train_state(model, exp), make_train_step(model, exp)


def program_run(cfg, dtype, steps, frozen=False, log_scale=None):
    """(losses, the first step's gradients, the leaves after ``steps``
    steps) of the port's train step."""
    model, state, step = build(cfg, dtype, frozen, log_scale)
    losses, first = [], None
    for b in batches(cfg, steps):
        losses.append(float(step(state, device_batch(b, "cpu"))["loss"]))
        if first is None:
            first = {n: (torch.zeros_like(p) if p.grad is None
                         else p.grad.clone())
                     for n, p in model.named_parameters()}
    return losses, first, {n: p.detach().clone()
                           for n, p in model.named_parameters()}


def reference_run(cfg, steps, log_scale=None):
    if log_scale is None:
        return clip_train.reference_train(cfg, SEED, batches(cfg, steps),
                                          "cpu")
    w = ref.initial_weights(cfg, sub_seed(SEED, "weights"), "cpu")
    w[ref.LOG_SCALE].fill_(log_scale)
    gen = torch.Generator().manual_seed(sub_seed(SEED, "generator"))
    return (*ref.train(cfg, w, batches(cfg, steps), gen, "cpu"), w)


def worst(got, want, base=None):
    """The largest over leaves of ||got - want|| / ||want|| (the leaf's
    change from ``base`` where given)."""
    out = 0.0
    for n, w in want.items():
        g = got[n]
        if base is not None:
            g, w = g - base[n], w - base[n]
        out = max(out, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_loss_and_every_gradient_match_the_reference(dtype):
    cfg = config()
    calls = vit_common.PlainVJP.backward_calls
    losses, grads, _ = program_run(cfg, dtype, 1)
    vjps = vit_common.PlainVJP.backward_calls - calls
    losses_r, grads_r, *_ = reference_run(cfg, 1)
    key = str(dtype).split(".")[1]
    assert abs(losses[0] - losses_r[0]) <= LOSS_TOL[key] * losses_r[0]
    assert set(grads) == set(grads_r)
    assert worst(grads, grads_r) <= GRAD_TOL[key]
    # bf16 takes K5's and K6's plain versions with their PlainVJP, f32
    # the plain blocks
    assert vjps == (2 * SIZES["layers"] if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_a_frozen_trunk_fails_the_gradient_comparison(dtype):
    cfg = config()
    _, grads, _ = program_run(cfg, dtype, 1, frozen=True)
    _, grads_r, *_ = reference_run(cfg, 1)
    trunk = {n: g for n, g in grads_r.items()
             if n.startswith(ref.TRUNK_PREFIX) and "head" not in n}
    assert worst(grads, trunk) > 0.99
    assert worst(grads, grads_r) > GRAD_TOL[str(dtype).split(".")[1]]


@pytest.mark.parametrize("optimizer,passes", [(None, True),
                                              (EVERY_LEAF, False)],
                         ids=["matrices", "every_leaf"])
def test_two_adamw_steps_match_the_reference(optimizer, passes):
    """CLIP's AdamW in f32: beta2 0.98, eps 1e-6 and the decay on the
    leaves of two or more axes, as the reference; the decay on every leaf
    moves the gains and biases off."""
    cfg = config(optimizer)
    losses, _, after = program_run(cfg, torch.float32, 2)
    losses_r, _, after_r, _, start = reference_run(config(), 2)
    if passes:
        assert losses[1] == pytest.approx(losses_r[1],
                                          rel=LOSS_TOL["float32"])
    got = worst(after, after_r, start)
    assert (got <= CHANGE_TOL) == passes, got
    if not passes:
        one_axis = {n: w for n, w in after_r.items() if w.dim() < 2}
        assert worst(after, one_axis, start) > 100 * CHANGE_TOL


def test_the_logit_scale_is_clipped_after_each_step():
    cfg = config()
    start = math.log(100.0) + 0.1
    _, _, after = program_run(cfg, torch.float32, 1, log_scale=start)
    _, _, after_r, *_ = reference_run(cfg, 1, log_scale=start)
    got = float(after[ref.LOG_SCALE])
    assert got == float(after_r[ref.LOG_SCALE]) == pytest.approx(
        math.log(100.0), abs=1e-6)


def test_cvcls_learned_temperature_is_not_clipped():
    d = json.loads((CONFIG.parent / "cvcl_resnext50.json").read_text())[
        "experiment"]
    d["model"].update(vocab_size=40, embedding_dim=16, fix_temperature=False)
    d["model"]["vision"]["cnn_model"] = "toy"
    d["parallel"]["compute_dtype"] = "float32"
    exp = ExperimentConfig.from_dict(d)
    model = CVCL(exp.model, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.model.logit_neg_log_temperature.fill_(5.0)
    model.clip_logit_scale()
    assert model.model.logit_neg_log_temperature.item() == 5.0


def test_the_trunks_backward_spans_nest_under_backward(monkeypatch):
    """Two ``mmb/vjp/*`` spans a vision block a step (K6's, then K5's,
    from the last block back), under ``mmb/backward``; without a profiler
    session no span, and no synchronising call, while the counter counts
    on."""
    store = SpanStore()
    monkeypatch.setattr(profiler, "SPANS", store)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    _, state, step = build(config(), torch.bfloat16)
    b = batches(config(), 1)[0]
    calls = vit_common.PlainVJP.backward_calls
    step(state, device_batch(b, "cpu"))
    assert store.spans == [] and store.stale and synced == []
    assert vit_common.PlainVJP.backward_calls - calls == 2 * SIZES["layers"]
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, device_batch(b, "cpu"))
    rows = store.table()
    (back,) = [i for i, r in enumerate(rows) if r["name"] == "mmb/backward"]
    assert [r["name"] for r in rows if r["parent"] == back] == [
        "mmb/vjp/mlp", "mmb/vjp/block_attention"] * SIZES["layers"]
    s = store.summary("mmb/train_step")
    assert s["steps"] == 1
    assert s["device_ms"]["mmb/vjp/mlp"] > 0
    assert s["device_ms"]["mmb/vjp/block_attention"] > 0


def test_the_optimizer_options():
    assert parse_optimizer("AdamW") == ("AdamW", {
        "beta2": 0.999, "eps": 1e-8, "decay": "all"})
    assert parse_optimizer("AdamW:beta2=0.98,eps=1e-6,decay=matrices") == (
        "AdamW", {"beta2": 0.98, "eps": 1e-6, "decay": "matrices"})
    for bad in ("Adamw", "AdamW:beta1=0.8", "AdamW:decay=some",
                "AdamW:eps=small", "SGD:decay=matrices", "Adam:eps=1e-6"):
        with pytest.raises(ValueError):
            parse_optimizer(bad)


def test_cvcls_adamw_keeps_its_build():
    """The bare name: one group, every trainable leaf decayed, optax's
    betas and eps, as before the options."""
    d = json.loads((CONFIG.parent / "cvcl_resnext50.json").read_text())[
        "experiment"]
    d["model"].update(vocab_size=40, embedding_dim=16)
    d["model"]["vision"]["cnn_model"] = "toy"
    d["train"].update(lr=1e-4, weight_decay=0.1)
    exp = ExperimentConfig.from_dict(d)
    model = CVCL(exp.model, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    opt = build_optimizer(exp, model)
    (group,) = opt.param_groups
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 0.1)
    assert len(group["params"]) == sum(
        p.requires_grad for p in model.parameters())


# -- the eval-only CLIPModel, against its forward before the towers could
# train (kept here as it was)

def vision_before(tower, pixel_values):
    dt = tower.dtype
    with torch.no_grad():
        x = pixel_values.to(tower.class_embedding.device, dt)
        patches = F.conv2d(x, tower.patch_embedding.weight.to(dt),
                           stride=tower.cfg.patch_size)
        Bn, C = patches.shape[:2]
        tokens = torch.cat([tower.class_embedding.expand(Bn, 1, C),
                            patches.flatten(2).transpose(1, 2).float()],
                           dim=1) + tower.position_embedding.weight
        tokens = tower.pre_layrnorm(tokens).to(dt)
        if dt == torch.bfloat16:
            weights = per_weight_state(
                {}, tower.blocks, ("kernels", dt),
                lambda b: b.kernel_weights(dt))
            for blk, w in zip(tower.blocks, weights):
                tokens = blk.forward_kernels(tokens, w, tower.kernels)
        else:
            for blk in tower.blocks:
                tokens = blk(tokens, tower.kernels.gelu)
        return tower.post_layernorm(tokens[:, 0].float())


def _ln(norm, x):
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, norm.eps)


def text_before(tower, ids, attention_mask):
    L = ids.shape[1]
    with torch.no_grad():
        x = tower.token_embedding(ids) + tower.position_embedding.weight[:L]
        allowed = torch.ones(L, L, dtype=torch.bool).tril()[None, None]
        if attention_mask is not None:
            allowed = allowed & attention_mask.bool()[:, None, None, :]
        for blk in tower.blocks:
            Bn, L, D = x.shape
            H = blk.attn.num_heads
            qkv = blk.attn.qkv(_ln(blk.norm1, x))
            q, k, v = qkv.view(Bn, L, 3, H, D // H).permute(2, 0, 3, 1, 4)
            y = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
            x = x + blk.attn.proj(y.transpose(1, 2).reshape(Bn, L, D))
            h = gelu(blk.mlp.fc1(_ln(blk.norm2, x)), tower.cfg.gelu)
            x = x + blk.mlp.fc2(h)
        x = _ln(tower.final_layer_norm, x)
        eos = ids.argmax(-1)
        return x[torch.arange(Bn), eos]


@pytest.mark.parametrize("tower,dtype", [
    ("vision", torch.float32), ("vision", torch.bfloat16),
    ("text", torch.float32), ("text_masked", torch.float32)])
def test_the_eval_clip_model_is_unchanged(tower, dtype):
    torch.manual_seed(0)
    model = tclip.CLIPModel(TINY_CLIP, dtype=dtype, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3 if p.dim() > 1 else 0.5)
    if tower == "vision":
        x = torch.randn(3, 3, PX, PX)
        got = model.vision_model(x)
        assert torch.equal(got, vision_before(model.vision_model, x))
        assert not got.requires_grad
        return
    ids = torch.randint(0, 126, (3, 16))
    ids[:, 9] = 127
    mask = (torch.arange(16) <= 9)[None].expand(3, 16).int() \
        if tower == "text_masked" else None
    got = model.text_model(ids, mask)
    assert torch.equal(got, text_before(model.text_model, ids, mask))
    assert not got.requires_grad
