"""One train step of the published recipe's CVCL with the int8 trunk, the
port against the JAX package on the CPU.

The recipe (``bench.py:102-121``): int8 layers 3-4, the default kernel
plan, running BN, fixed T, the embedding text encoder; here at B = 32 (the
int8 plans' batch multiple) on 64 px frames with the augment off and a
32-d head. Each side calibrates its trunk on the batch, as
``bench.py:146-151`` does. The JAX side runs its fused trunk
(``MMB_FUSED_TRUNK=1``, ``MMB_TRUNK_INT8=0,0,1,1``; interpret mode, under
``jit``), the port its folded plan's plain versions.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models.quant_calib import (
    calibrate_cvcl as j_calibrate_cvcl)
from multimodal_baby_tpu.train import build_optimizer as j_build_optimizer
from multimodal_baby_tpu.train.step import make_loss_fn as j_make_loss_fn
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.step import (
    calibrate_trunk, init_train_state, make_train_step)

from test_torch_int8_trunk import MIXED, random_variables

B, E, V, L, IMG = 32, 32, 64, 10, 64
# Of each tensor's largest value. The two trunks' pooled features agree to
# a per-row cosine of ~0.9996 (bf16 rounding in layers 1-2 differs between
# the packages), so they differ by sqrt(2 (1 - cos)) ~ 3% of their norm:
# the head gradients, outer products with them, move by that much, the
# loss in the third digit. AdamW's first step moves each element by about
# +-lr, so where a gradient is near 0 the two updates may take opposite
# signs: the updated heads are held to 2 lr everywhere and to 0.1 lr in all
# but 5% of the elements.
STEP_TOL = 5e-3
GRAD_TOL = 5e-2
LR = 1e-3


def test_int8_cvcl_train_step_matches_jax(monkeypatch):
    cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=E, vocab_size=V, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=jcfg.VisionConfig(frozen_bn="running", trunk_int8=MIXED),
            text=jcfg.TextConfig(text_encoder="embedding")),
        train=jcfg.TrainConfig(lr=LR, weight_decay=0.1))
    rng = np.random.RandomState(8)
    text = np.zeros((B, L), np.int32)
    text_len = rng.randint(2, L, B).astype(np.int32)
    for i, n in enumerate(text_len):
        text[i, :n] = rng.randint(4, V, n)
    batch = {"image": rng.randn(B, IMG, IMG, 3).astype(np.float32),
             "text": text, "text_len": text_len}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    monkeypatch.delenv("MMB_FUSED_TRUNK", raising=False)
    monkeypatch.delenv("MMB_TRUNK_PLAN", raising=False)
    small = {k: v[:2] for k, v in jb.items()}  # shapes only: a cheap init
    params = jax.tree.map(np.asarray, JCVCL(cfg.model).init(
        jax.random.PRNGKey(0), *small.values())["params"])
    params["vision_encoder"]["backbone"], bstats = random_variables(IMG, 9)
    stats = {"vision_encoder": {"backbone": bstats}}
    scales = j_calibrate_cvcl({"params": params, "batch_stats": stats},
                              jb["image"][:32])["quant_scales"]

    monkeypatch.setenv("MMB_FUSED_TRUNK", "1")
    monkeypatch.setenv("MMB_TRUNK_INT8", "0,0,1,1")
    model = JCVCL(cfg.model, dtype=jnp.bfloat16)
    loss_fn = j_make_loss_fn(model, cfg, extra_cols={"quant_scales": scales})
    optimizer = j_build_optimizer(cfg, params)

    @jax.jit
    def step(params):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, jb, jax.random.PRNGKey(0), True)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        return loss, grads, jax.tree.map(lambda p, u: p + u, params, updates)

    want_loss, grads, new_params = jax.tree.map(np.asarray, step(params))

    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    port = CVCL(tc.model, dtype=torch.bfloat16, device="cpu")
    sd = cvcl_state_dict(params, stats)
    sd.update({k: v.numpy() for k, v in port.state_dict().items()
               if k.endswith("amax")})
    load_state_dict(port, sd)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    assert calibrate_trunk(port, tb) is not None
    trunk = port.vision_encoder.model
    assert float(trunk.layer4[2].out_amax) > 0
    # the CPU takes the conv path; run the folded plan's plain versions
    monkeypatch.setattr(trunk, "forward", lambda x, train=False:
                        trunk.forward_folded(x.to(trunk.dtype)))
    metrics = make_train_step(port, tc)(init_train_state(port, tc), tb)

    def close(got, want, what, tol=STEP_TOL):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max() or err == 0, (
            what, err, np.abs(want).max())

    close(metrics["loss"], want_loss, "loss")
    want_grads = cvcl_state_dict(grads, stats)
    want_new = cvcl_state_dict(new_params, stats)
    got_new = port.state_dict()
    checked = 0
    for name, p in port.named_parameters():
        if p.requires_grad:
            close(p.grad, want_grads[name], name, GRAD_TOL)
            step_diff = np.abs(got_new[name].numpy() - want_new[name])
            assert step_diff.max() <= 2.02 * LR, (name, step_diff.max())
            assert (step_diff > 0.1 * LR).mean() < 0.05, (
                name, (step_diff > 0.1 * LR).mean())
            checked += 1
    assert checked == 4
    for name, v in got_new.items():  # the trunk and its ranges did not move
        if name.startswith("vision_encoder.model.") and ".fc." not in name:
            assert name.endswith("amax") or np.array_equal(
                v.numpy(), np.asarray(sd[name], np.float32)), name
