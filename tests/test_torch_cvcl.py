"""The port's CVCL, loss, train step and weight bridge against the JAX package.

The same weights (JAX-initialised, BN statistics perturbed, moved through
the port's weight bridge) and the same numpy-seeded batch go through both
packages on the CPU in f32: ResNeXt-50 at full width on 32x32 images, a
32-d flat head, the embedding text encoder. Tolerances are stated where
they are used.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.api.convert import convert_cvcl_checkpoint
from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.core import constants as jconst
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models.losses import (
    contrastive_loss_from_logits as j_contrastive)
from multimodal_baby_tpu.train import build_optimizer as j_build_optimizer
from multimodal_baby_tpu.train.step import (
    TrainState as JTrainState, make_loss_fn as j_make_loss_fn,
    make_train_step as j_make_train_step)
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.core import constants as tconst
from multimodal_baby_tpu_torch.models.losses import (
    contrastive_loss_from_logits)
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.optimizer import frozen_mask
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_eval_step, make_train_step)

B, E, V, L, IMG = 6, 32, 64, 10, 32
RTOL = 1e-4       # forward outputs: f32 trunk, other summation orders
STEP_RTOL = 1e-5  # loss, head gradients and updated heads


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def make_cfg(fix_temperature=True, tie=True):
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=E, vocab_size=V, embedding_type="flat",
            normalize_features=True, fix_temperature=fix_temperature,
            temperature=0.07, tie=tie,
            vision=jcfg.VisionConfig(frozen_bn="running"),
            text=jcfg.TextConfig(text_encoder="embedding")),
        train=jcfg.TrainConfig(lr=1e-3, weight_decay=0.1))


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((B, L), np.int32)
    text_len = rng.randint(2, L, B).astype(np.int32)
    for i, n in enumerate(text_len):
        text[i, :n] = rng.randint(4, V, n)
    return {"image": rng.randn(B, IMG, IMG, 3).astype(np.float32),
            "text": text, "text_len": text_len}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _perturb_stats(tree, rng):
    return {k: (_perturb_stats(v, rng) if isinstance(v, dict) else
                (rng.uniform(.5, 2., v.shape) if k == "var"
                 else .1 * rng.randn(*v.shape)).astype(np.float32))
            for k, v in tree.items()}


def build_pair(cfg):
    """(JAX model, params, batch_stats, port model) on the same weights."""
    batch = make_batch()
    model = JCVCL(cfg.model)
    variables = model.init(jax.random.PRNGKey(0),
                           *jax_batch(batch).values())
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _perturb_stats(jax.device_get(variables["batch_stats"]),
                           np.random.RandomState(1))
    port = CVCL(tcfg.ExperimentConfig.from_json(cfg.to_json()).model,
                device="cpu")
    load_state_dict(port, cvcl_state_dict(params, stats))
    return model, params, stats, port


@pytest.fixture(scope="module")
def pair():
    return build_pair(make_cfg())


def test_config_and_constants_match_the_jax_package():
    """The port's copies of the config dataclasses and constants hold the
    same fields, defaults and values, and the copy of the constants every
    name of the original (the port imports nothing of JAX)."""
    for name in ("VisionConfig", "TextConfig", "ModelConfig", "TrainConfig",
                 "DataConfig", "ParallelConfig", "ExperimentConfig"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert ([f.name for f in dataclasses.fields(j)]
                == [f.name for f in dataclasses.fields(t)]), name
        assert dataclasses.asdict(j()) == dataclasses.asdict(t()), name
    cfg = make_cfg()
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()).to_json() \
        == cfg.to_json()
    for name in dir(tconst):
        if name.isupper():
            assert getattr(tconst, name) == getattr(jconst, name), name
    # and every constant of the original has its copy
    assert {n for n in dir(jconst) if n.isupper()} <= set(dir(tconst))


def test_logits_and_features_match_jax(pair):
    model, params, stats, port = pair
    batch = make_batch(2)
    lpi, lpt, feats, fmap = model.apply(
        {"params": params, "batch_stats": stats}, *jax_batch(batch).values(),
        return_image_features=True)
    with torch.no_grad():
        t_lpi, t_lpt, t_feats, t_fmap = port(
            *torch_batch(batch).values(), return_image_features=True)
    for got, want in ((t_lpi, lpi), (t_lpt, lpt), (t_feats, feats),
                      (t_fmap, fmap)):
        assert tuple(got.shape) == want.shape
        assert rel_err(got, want) < RTOL


def test_text_encoder_matches_jax(pair):
    """Embedding mean: sum over the padded window / true length, then the
    L2 normalisation (exact up to f32 summation order)."""
    model, params, stats, port = pair
    batch = make_batch(3)
    feats, outputs = model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(batch["text"]), jnp.asarray(batch["text_len"]),
        method="encode_text")
    tb = torch_batch(batch)
    with torch.no_grad():
        t_feats, t_outputs = port.encode_text(tb["text"], tb["text_len"])
    np.testing.assert_allclose(t_outputs.numpy(), np.asarray(outputs),
                               rtol=0, atol=0)
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(feats),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_valid", [False, True])
def test_contrastive_loss_matches_jax(with_valid):
    rng = np.random.RandomState(4)
    lpi = (rng.randn(8, 8) * 3).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool) if with_valid else None
    want, wm = j_contrastive(jnp.asarray(lpi), jnp.asarray(lpi.T),
                             None if valid is None else jnp.asarray(valid))
    got, gm = contrastive_loss_from_logits(
        torch.from_numpy(lpi), torch.from_numpy(lpi.T).contiguous(),
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert sorted(gm) == sorted(wm)
    for k in gm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_frozen_mask_freezes_the_trunk_only(pair):
    *_, port = pair
    mask = frozen_mask(port, finetune_cnn=False)
    trainable = sorted(k for k, v in mask.items() if v)
    assert trainable == ["language_model.output_layer.bias",
                         "text_encoder.embedding.weight",
                         "vision_encoder.model.fc.bias",
                         "vision_encoder.model.fc.weight"]
    assert all(frozen_mask(port, finetune_cnn=True).values())


def test_frozen_mask_keeps_either_head():
    """The trunk of either backbone is frozen; its head, ``fc`` (ResNeXt)
    or ``head`` (ViT), stays trainable."""
    model = torch.nn.Module()
    model.vision_encoder = torch.nn.Module()
    trunk = model.vision_encoder.model = torch.nn.Module()
    for name in ("layer1", "blocks", "fc", "head"):
        setattr(trunk, name, torch.nn.Linear(2, 2))
    model.text_encoder = torch.nn.Linear(2, 2)
    mask = frozen_mask(model, finetune_cnn=False)
    assert sorted(k for k, v in mask.items() if v) == [
        "text_encoder.bias", "text_encoder.weight",
        "vision_encoder.model.fc.bias", "vision_encoder.model.fc.weight",
        "vision_encoder.model.head.bias", "vision_encoder.model.head.weight"]


@pytest.mark.parametrize("what", ["CVCL", "VisionEncoder", "TextEncoder"])
def test_entry_points_build_on_the_card_unless_asked(what):
    """With no device given, the model goes to the card; where there is
    none that raises, and device="cpu" builds on the CPU."""
    from multimodal_baby_tpu_torch.models.text import TextEncoder
    from multimodal_baby_tpu_torch.models.vision import VisionEncoder
    cls = {"CVCL": CVCL, "VisionEncoder": VisionEncoder,
           "TextEncoder": TextEncoder}[what]
    cfg = tcfg.ExperimentConfig.from_json(make_cfg().to_json()).model
    if torch.cuda.is_available():
        built = cls(cfg)
        assert next(built.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg)
    built = cls(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in built.parameters())


def test_init_train_state_takes_the_model_device(pair):
    *_, port = pair
    cfg = tcfg.ExperimentConfig.from_json(make_cfg().to_json())
    state = init_train_state(port, cfg)
    assert state.generator.device == next(port.parameters()).device
    assert state.generator.initial_seed() == cfg.train.seed


@pytest.mark.parametrize("fix_temperature", [True, False])
def test_train_step_matches_jax(fix_temperature):
    """One AdamW step from the same weights and batch, augment off: the
    same loss, head gradients and updated parameters as make_train_step
    (STEP_RTOL relative to each tensor's largest value); the frozen trunk
    does not move."""
    cfg = make_cfg(fix_temperature=fix_temperature)
    model, params, stats, port = build_pair(cfg)
    batch = make_batch(5)
    jb = jax_batch(batch)

    loss_fn = j_make_loss_fn(model, cfg)
    (want_loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, stats, jb, jax.random.PRNGKey(0), True)
    optimizer = j_build_optimizer(cfg, params)
    state = JTrainState(params, stats, optimizer.init(params),
                        jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    new_state, _ = j_make_train_step(model, cfg, optimizer,
                                     donate=False)(state, jb)

    tcfg_ = tcfg.ExperimentConfig.from_json(cfg.to_json())
    t_state = init_train_state(port, tcfg_)
    metrics = make_train_step(port, tcfg_)(t_state, torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=STEP_RTOL)

    want_grads = cvcl_state_dict(jax.tree.map(np.asarray, grads), stats)
    want_new = cvcl_state_dict(jax.tree.map(np.asarray, new_state.params),
                               new_state.batch_stats)
    got_new = port.state_dict()
    checked = 0
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert rel_err(p.grad, want_grads[name]) < STEP_RTOL or (
                np.abs(want_grads[name]).max() == 0
                and float(p.grad.abs().max()) == 0), name
            checked += 1
        assert rel_err(got_new[name], want_new[name]) < STEP_RTOL, name
    assert checked == (4 if fix_temperature else 5)


def test_eval_step_matches_jax_loss(pair):
    model, params, stats, port = pair
    batch = make_batch(6)
    cfg = make_cfg()
    want, _ = j_make_loss_fn(model, cfg)(
        params, stats, jax_batch(batch), jax.random.PRNGKey(0), False)
    got = make_eval_step(port, tcfg.ExperimentConfig.from_json(
        cfg.to_json()))(torch_batch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want), rtol=RTOL)


@pytest.mark.parametrize("fix_temperature,tie", [(True, True),
                                                 (False, False)])
def test_weight_bridge_round_trip(fix_temperature, tie):
    """port state_dict -> the JAX package's convert_cvcl_checkpoint ->
    the port's cvcl_state_dict gives back every tensor exactly, in the tree
    the JAX CVCL itself builds."""
    cfg = make_cfg(fix_temperature=fix_temperature, tie=tie)
    port = CVCL(tcfg.ExperimentConfig.from_json(cfg.to_json()).model,
                device="cpu", generator=torch.Generator().manual_seed(7))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_cvcl_checkpoint(sd, "embedding", tie=tie)
    back = cvcl_state_dict(params, stats)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    variables = jax.eval_shape(
        JCVCL(cfg.model).init, jax.random.PRNGKey(0),
        *jax_batch(make_batch()).values())
    assert jax.tree.structure(params) == jax.tree.structure(
        variables["params"])
    assert jax.tree.structure(stats) == jax.tree.structure(
        variables["batch_stats"])


def test_layers_match_jax():
    """length_mask exactly, and padding_safe_embed's lookup and gradient:
    lookups of the PAD row pass it no gradient."""
    from multimodal_baby_tpu.models.layers import (
        length_mask as j_length_mask, padding_safe_embed as j_embed)
    from multimodal_baby_tpu_torch.models.layers import (
        length_mask, padding_safe_embed)
    rng = np.random.RandomState(8)
    lens = rng.randint(0, L + 1, B).astype(np.int32)
    np.testing.assert_array_equal(
        length_mask(torch.from_numpy(lens), L).numpy(),
        np.asarray(j_length_mask(jnp.asarray(lens), L)))
    table = rng.randn(V, E).astype(np.float32)
    ids = rng.randint(0, 4, (B, L)).astype(np.int32)  # PAD (0) included
    weights = rng.randn(B, L, E).astype(np.float32)
    j_val, j_grad = jax.value_and_grad(
        lambda t: (j_embed(t, jnp.asarray(ids)) * weights).sum())(
            jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = padding_safe_embed(t, torch.from_numpy(ids).long())
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(out.sum().item(),
                               float(np.asarray(j_embed(
                                   jnp.asarray(table), jnp.asarray(ids))).sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-6, atol=1e-6)
    assert float(t.grad[0].abs().max()) == 0.0
