"""The ViT flagship CVCL (DINO ViT-B/14 at full width and depth, flat
512-d heads, the 1-layer transformer text encoder with a learned
pos-embed, fixed T = 0.07) against the JAX package on the same weights.

JAX initialises the model; LayerNorms, biases and the text pos-embed are
perturbed so that they matter; the weights move into the port through
``api/convert.py``. On the CPU in f32, at B = 2 and 224 px, with train =
False (no dropout): logits, loss and the gradient of every trainable
parameter agree to atol 1e-4 (f32 through 12 blocks, other summation
orders); then one AdamW update from the same gradients gives the same
parameters to atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_baby_tpu.api.convert import convert_cvcl_checkpoint
from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.train import build_optimizer as j_build_optimizer
from multimodal_baby_tpu.train.step import make_loss_fn as j_make_loss_fn
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_loss_fn)

B, V, L = 2, 100, 25
ATOL = 1e-4


def make_cfg():
    """bench.py's ViT flagship (build_vit_flagship) at a small vocabulary."""
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=512, vocab_size=V, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=jcfg.VisionConfig(vit_dino=True),
            text=jcfg.TextConfig(text_encoder="transformer",
                                 pos_embed_type="learned")),
        train=jcfg.TrainConfig(optimizer="AdamW", lr=1e-4,
                               weight_decay=0.1))


def make_batch():
    rng = np.random.RandomState(0)
    lens = rng.randint(3, L, B).astype(np.int32)
    text = np.zeros((B, L), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(4, V, n)
    return {"image": rng.randn(B, 224, 224, 3).astype(np.float32),
            "text": text, "text_len": lens}


def perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k in ("bias", "in_proj_bias") or (k == "pos_embed"
                                               and v.ndim == 2):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run():
    cfg = make_cfg()
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JCVCL(cfg.model)
    params = perturb(model.init(jax.random.PRNGKey(0), jb["image"],
                                jb["text"], jb["text_len"])["params"],
                     np.random.RandomState(1))
    (loss, (metrics, _)), grads = jax.value_and_grad(
        j_make_loss_fn(model, cfg), has_aux=True)(
            params, {}, jb, jax.random.PRNGKey(0), False)
    lpi, lpt = model.apply({"params": params}, jb["image"], jb["text"],
                           jb["text_len"])
    optimizer = j_build_optimizer(cfg, params)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    new_params = optax.apply_updates(params, updates)
    want = {"loss": float(loss), "lpi": np.asarray(lpi),
            "tree": jax.tree.structure(params),
            "lpt": np.asarray(lpt),
            "grads": cvcl_state_dict(jax.tree.map(np.asarray, grads), {},
                                     vit=True),
            "new": cvcl_state_dict(jax.tree.map(np.asarray, new_params), {},
                                   vit=True)}

    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    port = CVCL(t_cfg.model, device="cpu")
    load_state_dict(port, cvcl_state_dict(params, {}, vit=True))
    state = init_train_state(port, t_cfg)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    t_loss, _ = make_loss_fn(port, t_cfg)(tb, False)
    t_loss.backward()
    with torch.no_grad():
        t_lpi, t_lpt = port(tb["image"], tb["text"], tb["text_len"])
    return want, port, state, float(t_loss.detach()), t_lpi, t_lpt


def test_logits_and_loss_match_jax(run):
    want, _, _, t_loss, t_lpi, t_lpt = run
    np.testing.assert_allclose(t_lpi.numpy(), want["lpi"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lpt.numpy(), want["lpt"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_loss, want["loss"], atol=ATOL, rtol=0)


def test_trainable_gradients_match_jax(run):
    want, port, *_ = run
    trainable = {n: p for n, p in port.named_parameters() if p.requires_grad}
    assert sorted(trainable) == sorted(
        ["language_model.output_layer.bias", "text_encoder.embedding.weight",
         "text_encoder.pos_embed", "vision_encoder.model.head.bias",
         "vision_encoder.model.head.weight"]
        + [f"text_encoder.transformer_encoder.layers.0.{k}" for k in (
            "self_attn.in_proj_weight", "self_attn.in_proj_bias",
            "self_attn.out_proj.weight", "self_attn.out_proj.bias",
            "linear1.weight", "linear1.bias", "linear2.weight",
            "linear2.bias", "norm1.weight", "norm1.bias", "norm2.weight",
            "norm2.bias")])
    for name, p in trainable.items():
        grad = (p.grad if p.grad is not None else torch.zeros_like(p))
        np.testing.assert_allclose(grad.numpy(), want["grads"][name],
                                   atol=ATOL, rtol=0, err_msg=name)


def test_adamw_update_from_the_same_gradients_matches_jax(run):
    want, port, state, *_ = run
    frozen = {n: p.detach().clone() for n, p in port.named_parameters()
              if not p.requires_grad}
    state.optimizer.zero_grad(set_to_none=True)
    for name, p in port.named_parameters():
        if p.requires_grad:
            p.grad = torch.from_numpy(want["grads"][name].copy())
    state.optimizer.step()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want["new"][name],
                                   atol=1e-6, rtol=0, err_msg=name)
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name


def test_weight_bridge_round_trip(run):
    """port state_dict -> the JAX package's convert_cvcl_checkpoint (ViT,
    transformer text encoder) -> the port's cvcl_state_dict gives back
    every tensor exactly, in the tree the JAX CVCL itself builds."""
    want, port, *_ = run
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    params, stats = convert_cvcl_checkpoint(sd, "transformer", vit=True)
    assert stats == {}
    assert jax.tree.structure(params) == want["tree"]
    back = cvcl_state_dict(params, stats, vit=True)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
