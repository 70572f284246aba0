"""The ViT's kernel configurations (``ViTKernels``) against the JAX
package's ViT on the same weights.

- ``ViTKernels`` takes every spelling of the JAX package's
  ``MMB_FUSED_ATTN`` and ``MMB_VIT_MLP`` and rejects anything else.
- A 2-block toy ViT (embed 128, 2 heads of 64, patch 14, 56 px: 17 tokens)
  in each configuration, in bf16, against the JAX ``VisionTransformerDino``
  in bf16 on the same bridged weights (the JAX package takes its XLA path on
  the CPU, with ``MMB_VIT_GELU`` set for the GELU forms; the port its kernel
  path, whose wrappers run their plain versions on CPU tensors): per-row
  CLS cosine >= 0.999, and a spy on the kernel wrappers shows that each
  configuration calls its own kernels, once per block, and no other.
- One state dict loads into every configuration.
- ``get_last_selfattention`` and ``get_intermediate_layers`` against JAX in
  f32: atol 1e-4 (as tests/test_torch_vit.py).
- The ViT flagship CVCL (ViT-B/14, at 56 px to keep it small) with
  ``whole_block=True`` and with ``attn="qkv"``, its trunk forced onto the
  kernel path in f32: logits, loss and trainable gradients against the JAX
  step at atol 1e-4, then one AdamW update from the same gradients at atol
  1e-6 (the tolerances of tests/test_torch_cvcl_vit.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models.vision_vit import (
    VisionTransformerDino as JViT)
from multimodal_baby_tpu.train import build_optimizer as j_build_optimizer
from multimodal_baby_tpu.train.step import make_loss_fn as j_make_loss_fn
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict, vit_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models import vision_vit
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.vision_vit import (
    ViTKernels, VisionTransformerDino)
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_loss_fn)

KW = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2,
          base_img_size=56)
KERNELS = ("fused_block_attention", "fused_mlp", "fused_vit_block",
           "fused_attention", "fused_attention_pairs",
           "fused_qkv_attention_pairs")

# configuration -> the kernels one forward of the 2-block toy calls
CONFIGS = {
    "default": (ViTKernels(), {"fused_block_attention": 2, "fused_mlp": 2}),
    "heads_first": (ViTKernels(attn="1"),
                    {"fused_attention": 2, "fused_mlp": 2}),
    "pairs": (ViTKernels(attn="pairs"),
              {"fused_attention_pairs": 2, "fused_mlp": 2}),
    "qkv": (ViTKernels(attn="3"),
            {"fused_qkv_attention_pairs": 2, "fused_mlp": 2}),
    "plain": (ViTKernels(attn="0", mlp=""), {}),
    "pairs_plain_mlp": (ViTKernels(attn="2", mlp="off"),
                        {"fused_attention_pairs": 2}),
    "whole_block": (ViTKernels(whole_block=True), {"fused_vit_block": 2}),
    "tanh": (ViTKernels(gelu="tanh"),
             {"fused_block_attention": 2, "fused_mlp": 2}),
    "sigmoid_whole_block": (ViTKernels(whole_block=True, gelu="sigmoid"),
                            {"fused_vit_block": 2}),
}


def perturb(tree, rng):
    """LayerNorm scales 1 + 0.1 N(0, 1), every bias (and the text
    pos-embed) 0.1 N(0, 1)."""
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


@pytest.mark.parametrize("attn,want", [
    ("block", "block"), ("1", "1"), ("2", "pairs"), ("pairs", "pairs"),
    ("3", "qkv"), ("qkv", "qkv"), ("0", "off"), ("off", "off")])
def test_vit_kernels_takes_every_jax_spelling(attn, want):
    k = ViTKernels(attn=attn)
    assert k.attn == want and k == ViTKernels(attn=want)
    for mlp, canon in (("fused", "fused"), ("", "off"), ("off", "off")):
        assert ViTKernels(mlp=mlp).mlp == canon
    for gelu in ("erf", "tanh", "sigmoid"):
        assert ViTKernels(gelu=gelu).gelu == gelu


@pytest.mark.parametrize("bad", [
    {"attn": "Block"}, {"attn": "4"}, {"attn": None}, {"mlp": "fuse"},
    {"mlp": "1"}, {"gelu": "relu"}, {"gelu": "ERF"}, {"whole_block": 1},
    {"whole_block": "1"}])
def test_vit_kernels_rejects_a_typo(bad):
    with pytest.raises(ValueError):
        ViTKernels(**bad)


@pytest.fixture(scope="module")
def toy():
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    params = perturb(jax.jit(JViT(**KW).init)(jax.random.PRNGKey(0), x)
                     ["params"], np.random.RandomState(0))
    return params, vit_state_dict(params)


def test_trunk_setter_validates(toy):
    port = VisionTransformerDino(**KW, device="cpu")
    assert port.vit_kernels == ViTKernels()
    port.vit_kernels = ViTKernels(attn="qkv")
    assert port.vit_kernels.attn == "qkv"
    with pytest.raises(TypeError):
        port.vit_kernels = "qkv"
    port.vit_kernels = None
    assert port.vit_kernels == ViTKernels()


def test_one_state_dict_loads_into_every_configuration(toy):
    _, sd = toy
    states = []
    for kernels, _ in CONFIGS.values():
        port = VisionTransformerDino(**KW, device="cpu", vit_kernels=kernels)
        load_state_dict(port, sd)
        states.append(port.state_dict())
    assert sorted(states[0]) == sorted(sd)
    for st in states[1:]:
        assert sorted(st) == sorted(states[0])
        for k, v in st.items():
            assert torch.equal(v, states[0][k]), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax_and_calls_its_kernels(toy, name,
                                                         monkeypatch):
    params, sd = toy
    kernels, want_calls = CONFIGS[name]
    monkeypatch.setenv("MMB_VIT_GELU", kernels.gelu)
    x = np.random.RandomState(1).randn(2, 56, 56, 3).astype(np.float32)
    want = np.array(JViT(**KW, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x)))

    port = VisionTransformerDino(**KW, dtype=torch.bfloat16, device="cpu",
                                 vit_kernels=kernels)
    load_state_dict(port, sd)
    calls = dict.fromkeys(KERNELS, 0)
    for kname in KERNELS:
        def spy(*a, _fn=getattr(vision_vit, kname), _name=kname, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(vision_vit, kname, spy)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert calls == {k: want_calls.get(k, 0) for k in KERNELS}
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128)
    cos = torch.nn.functional.cosine_similarity(
        got, torch.from_numpy(want), dim=1)
    assert torch.isfinite(got).all() and float(cos.min()) >= 0.999, cos


def test_probes_match_jax(toy):
    params, sd = toy
    port = VisionTransformerDino(**KW, device="cpu")
    load_state_dict(port, sd)
    x = np.random.RandomState(2).randn(2, 56, 56, 3).astype(np.float32)
    model = JViT(**KW)
    want_attn = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                       method=JViT.get_last_selfattention))
    want_layers = model.apply({"params": params}, jnp.asarray(x), 2,
                              method=JViT.get_intermediate_layers)
    with torch.no_grad():
        got_attn = port.get_last_selfattention(torch.from_numpy(x))
        got_layers = port.get_intermediate_layers(torch.from_numpy(x), 2)
    assert tuple(got_attn.shape) == (2, 2, 17, 17)
    np.testing.assert_allclose(got_attn.numpy(), want_attn, atol=1e-4,
                               rtol=0)
    assert len(got_layers) == len(want_layers) == 2
    for got, want in zip(got_layers, want_layers):
        assert tuple(got.shape) == (2, 17, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


# ------------------------------------------------------------ the CVCL step

B, V, L = 2, 100, 25


@pytest.fixture(scope="module")
def jax_step():
    """The ViT flagship (bench.py's build_vit_flagship at a small
    vocabulary) on 56 px frames: JAX's loss, logits, gradients and the
    AdamW update, and the port's model (built once: a ViT-B init is slow
    on the CPU)."""
    cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=512, vocab_size=V, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=jcfg.VisionConfig(vit_dino=True),
            text=jcfg.TextConfig(text_encoder="transformer",
                                 pos_embed_type="learned")),
        train=jcfg.TrainConfig(optimizer="AdamW", lr=1e-4,
                               weight_decay=0.1))
    rng = np.random.RandomState(0)
    lens = rng.randint(3, L, B).astype(np.int32)
    text = np.zeros((B, L), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(4, V, n)
    batch = {"image": rng.randn(B, 56, 56, 3).astype(np.float32),
             "text": text, "text_len": lens}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JCVCL(cfg.model)
    params = perturb(jax.jit(model.init)(jax.random.PRNGKey(0), jb["image"],
                                         jb["text"], jb["text_len"])
                     ["params"], np.random.RandomState(1))
    loss_fn = j_make_loss_fn(model, cfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, {}, b, jax.random.PRNGKey(0), False),
        has_aux=True))(params, jb)
    lpi, _ = model.apply({"params": params}, jb["image"], jb["text"],
                         jb["text_len"])
    optimizer = j_build_optimizer(cfg, params)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    new = optax.apply_updates(params, updates)
    want = {"loss": float(loss), "lpi": np.asarray(lpi),
            "grads": cvcl_state_dict(jax.tree.map(np.asarray, grads), {},
                                     vit=True),
            "new": cvcl_state_dict(jax.tree.map(np.asarray, new), {},
                                   vit=True)}
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    port = CVCL(t_cfg.model, device="cpu")
    return t_cfg, port, batch, cvcl_state_dict(params, {}, vit=True), want


@pytest.mark.parametrize("kernels,kernel,calls", [
    (ViTKernels(whole_block=True), "fused_vit_block", 12),
    (ViTKernels(attn="qkv"), "fused_qkv_attention_pairs", 12)])
def test_cvcl_step_matches_jax(jax_step, kernels, kernel, calls,
                               monkeypatch):
    """One port model for both configurations: the trunk's setter switches
    them, and the weights are loaded anew."""
    t_cfg, port, batch, sd, want = jax_step
    load_state_dict(port, sd)
    port.zero_grad(set_to_none=True)
    trunk = port.vision_encoder.model
    trunk.vit_kernels = kernels
    # the kernel path in f32: the wrappers' plain versions on the CPU
    monkeypatch.setattr(trunk, "forward",
                        lambda x: trunk._run(x.float(), kernels=True))
    count = [0]
    real = getattr(vision_vit, kernel)

    def spy(*a, **kw):
        count[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(vision_vit, kernel, spy)
    state = init_train_state(port, t_cfg)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    loss, _ = make_loss_fn(port, t_cfg)(tb, False)
    loss.backward()
    assert count[0] == calls
    np.testing.assert_allclose(float(loss.detach()), want["loss"], atol=1e-4,
                               rtol=0)
    with torch.no_grad():
        lpi, _ = port(tb["image"], tb["text"], tb["text_len"])
    np.testing.assert_allclose(lpi.numpy(), want["lpi"], atol=1e-4, rtol=0)
    trainable = {n: p for n, p in port.named_parameters() if p.requires_grad}
    for name, p in trainable.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), want["grads"][name],
                                   atol=1e-4, rtol=0, err_msg=name)
    state.optimizer.zero_grad(set_to_none=True)
    for name, p in trainable.items():
        p.grad = torch.from_numpy(want["grads"][name].copy())
    state.optimizer.step()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want["new"][name],
                                   atol=1e-6, rtol=0, err_msg=name)
