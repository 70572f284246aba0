"""The ViT's opt-in modes against the JAX package's: ``int8_dense``
(``MMB_VIT_INT8``'s Dense) and the ViT with its block Denses in int8, its
LayerNorms folded into qkv and fc1 (``MMB_VIT_LNFOLD``), and both.

- ``int8_dense`` on seeded [16, 768] x [768, 512] (the JAX test's shape):
  the same weight and activation codes, and outputs within 1e-6 of the
  largest (both sum the int8 products exactly).
- A 3-block ViT (embed 96, 4 heads, 56 px: 17 tokens) in f32 with LayerNorm
  gamma and beta made non-trivial as ``tests/test_quant_trunk.py`` does, on
  the same bridged weights. LN-fold: atol 2e-4, rtol 1e-4 (the JAX test's
  tolerance against its own plain path). int8: the first block alone at
  atol 1e-5 (the same codes, the products summed exactly); the three
  blocks at per-row cosine >= 0.9995 (from block 2 on, an f32 rounding of
  an activation at a code's midpoint may move the code by one step,
  amax / 127 ~ 0.04 here, which the later blocks carry: the two paths
  then agree as two int8 runs whose codes differ in a few places), and
  > 0.99 to the f32 path (the JAX package's envelope).
- The dispatch, on a 2-block ViT whose heads the attention kernels take
  (embed 128, 2 heads of 64): in bf16 (the kernel path) each combination
  of the modes with the attention modes calls the kernels the JAX
  package's gates pick, once per block, and ``int8_dense`` 4 times per
  block with int8 (the table ``DISPATCH``); the CLS features stay at
  cosine >= 0.999 to the JAX package's XLA path in bf16.
- One converted state dict serves every mode; the modes are refused on a
  fine-tuned trunk; ``MMB_VIT_INT8=1`` and ``MMB_VIT_LNFOLD=1`` in the
  environment change nothing in the port.
"""

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models.vision_vit import (
    VisionTransformerDino as JViT)
from multimodal_baby_tpu.ops.quant import int8_dense as j_int8_dense
from multimodal_baby_tpu_torch.api.convert import (
    load_state_dict, vit_state_dict)
from multimodal_baby_tpu_torch.core.config import ModelConfig, VisionConfig
from multimodal_baby_tpu_torch.models import vision_vit
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.vision import VisionEncoder
from multimodal_baby_tpu_torch.models.vision_vit import (
    ViTKernels, VisionTransformerDino)
from multimodal_baby_tpu_torch.ops.quant import (
    dense_weight_codes, int8_dense, quantize_dynamic)

KW = dict(patch_size=14, embed_dim=96, depth=3, num_heads=4,
          base_img_size=56)
DEPTH = KW["depth"]
# the dispatch's toy: heads of 64, which the attention kernels take
KW_HEADS = dict(KW, embed_dim=128, depth=2, num_heads=2)
D = KW_HEADS["depth"]
FOLD_ATOL, FOLD_RTOL = 2e-4, 1e-4
INT8_ATOL, INT8_COS = 1e-5, 0.9995
KERNELS = ("fused_block_attention", "fused_mlp", "fused_vit_block",
           "fused_attention", "fused_attention_pairs",
           "fused_qkv_attention_pairs", "int8_dense")

# (ViTKernels fields) -> calls per forward of the 2-block toy, by the JAX
# package's gates: int8 or LN-fold skips K7, K5 and K6; the attention mode
# then picks K8b (block, pairs, and qkv with int8), K8c (qkv with LN-fold
# alone), K8a ("1") or plain softmax ("off")
K8A, K8B, K8C = ("fused_attention", "fused_attention_pairs",
                 "fused_qkv_attention_pairs")
DISPATCH = {
    "int8": (dict(int8=True), {K8B: D, "int8_dense": 4 * D}),
    "int8 pairs": (dict(int8=True, attn="pairs"),
                   {K8B: D, "int8_dense": 4 * D}),
    "int8 qkv": (dict(int8=True, attn="qkv"),
                 {K8B: D, "int8_dense": 4 * D}),
    "int8 1": (dict(int8=True, attn="1"),
               {K8A: D, "int8_dense": 4 * D}),
    "int8 off": (dict(int8=True, attn="off"), {"int8_dense": 4 * D}),
    "int8 whole_block": (dict(int8=True, whole_block=True),
                         {K8B: D, "int8_dense": 4 * D}),
    "lnfold": (dict(lnfold=True), {K8B: D}),
    "lnfold qkv": (dict(lnfold=True, attn="qkv"), {K8C: D}),
    "lnfold 1": (dict(lnfold=True, attn="1"), {K8A: D}),
    "lnfold whole_block": (dict(lnfold=True, whole_block=True),
                           {K8B: D}),
    "lnfold tanh": (dict(lnfold=True, gelu="tanh"), {K8B: D}),
    "both": (dict(int8=True, lnfold=True),
             {K8B: D, "int8_dense": 4 * D}),
    "both qkv": (dict(int8=True, lnfold=True, attn="qkv"),
                 {K8B: D, "int8_dense": 4 * D}),
}
MODES = {"int8": dict(int8=True), "lnfold": dict(lnfold=True),
         "both": dict(int8=True, lnfold=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread: beside the other test
    workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_codes(x, kernel):
    """The weight and activation codes ``int8_dense`` of the JAX package
    makes (its first lines, verbatim)."""
    xf = x.astype(jnp.float32)
    w_scale = jnp.maximum(
        jnp.max(jnp.abs(kernel.astype(jnp.float32)), axis=0), 1e-12) / 127.0
    w_q = jnp.clip(jnp.round(kernel.astype(jnp.float32) / w_scale),
                   -127, 127).astype(jnp.int8)
    a_scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    x_q = jnp.clip(jnp.round(xf / a_scale), -127, 127).astype(jnp.int8)
    return np.asarray(w_q), np.asarray(w_scale), np.asarray(x_q)


def test_int8_dense_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 768).astype(np.float32)
    w = (rng.randn(768, 512) / np.sqrt(768)).astype(np.float32)
    b = (rng.randn(512) * 0.1).astype(np.float32)
    w_q, w_scale, x_q = j_codes(jnp.asarray(x), jnp.asarray(w))
    codes, scale = dense_weight_codes(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(codes.numpy(), w_q.T)
    np.testing.assert_array_equal(scale.numpy(), w_scale)
    np.testing.assert_array_equal(
        quantize_dynamic(torch.from_numpy(x))[0].numpy(), x_q)
    want = np.asarray(j_int8_dense(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), out_dtype=jnp.float32))
    got = int8_dense(torch.from_numpy(x), codes, scale, torch.from_numpy(b),
                     torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # a bf16 input and output, a leading batch axis: the same sums
    got3 = int8_dense(torch.from_numpy(x).reshape(2, 8, 768), codes, scale,
                      torch.from_numpy(b))
    assert got3.dtype == torch.float32 and tuple(got3.shape) == (2, 8, 512)
    assert torch.equal(got3.reshape(16, 512), got)


def perturbed_params(kw=KW):
    """JAX-initialised toy ViT parameters with LayerNorm gamma * 1.3 + 0.1
    and beta + 0.05 (tests/test_quant_trunk.py:471-482)."""
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    params = jax.jit(JViT(**kw).init)(jax.random.PRNGKey(0), x)["params"]
    flat = flax.traverse_util.flatten_dict(jax.device_get(params))
    for k in list(flat):
        if len(k) >= 2 and k[-2].startswith("norm"):
            if k[-1] == "scale":
                flat[k] = flat[k] * 1.3 + 0.1
            elif k[-1] == "bias":
                flat[k] = flat[k] + 0.05
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def toy():
    params = perturbed_params()
    return params, vit_state_dict(params)


@pytest.fixture(scope="module")
def toy_heads():
    params = perturbed_params(KW_HEADS)
    return params, vit_state_dict(params)


def images(seed=1):
    return np.random.RandomState(seed).randn(2, 56, 56, 3).astype(np.float32)


def port_vit(sd, dtype=None, kw=KW, **modes):
    port = VisionTransformerDino(**kw, dtype=dtype, device="cpu",
                                 vit_kernels=ViTKernels(**modes))
    load_state_dict(port, sd)
    return port


def cosines(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def run_both(params, depth, modes, x):
    """(port, JAX) CLS features of the first ``depth`` blocks in f32."""
    kw = dict(KW, depth=depth)
    params = {k: v for k, v in params.items()
              if not (k.startswith("block") and int(k[5:]) >= depth)}
    want = np.asarray(JViT(**kw, **modes).apply({"params": params},
                                                jnp.asarray(x)))
    port = VisionTransformerDino(**kw, device="cpu",
                                 vit_kernels=ViTKernels(**modes))
    load_state_dict(port, vit_state_dict(params))
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy(), want


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax_f32(toy, mode):
    params, _ = toy
    x = images()
    got, want = run_both(params, DEPTH, MODES[mode], x)
    assert got.shape == want.shape == (2, 96)
    if mode == "lnfold":
        np.testing.assert_allclose(got, want, atol=FOLD_ATOL, rtol=FOLD_RTOL)
        return
    assert cosines(got, want).min() >= INT8_COS, cosines(got, want)
    one, one_want = run_both(params, 1, MODES[mode], x)
    np.testing.assert_allclose(one, one_want, atol=INT8_ATOL, rtol=0)
    # the JAX package's envelope of the int8 path from f32 (> 0.99)
    f32 = np.asarray(JViT(**KW).apply({"params": params}, jnp.asarray(x)))
    assert cosines(got, f32).min() > 0.99, cosines(got, f32)


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_table(toy_heads, name, monkeypatch):
    params, sd = toy_heads
    fields, want_calls = DISPATCH[name]
    port = port_vit(sd, torch.bfloat16, KW_HEADS, **fields)
    calls = dict.fromkeys(KERNELS, 0)
    for kname in KERNELS:
        def spy(*a, _fn=getattr(vision_vit, kname), _name=kname, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(vision_vit, kname, spy)
    x = images(2)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert calls == {k: want_calls.get(k, 0) for k in KERNELS}
    monkeypatch.setenv("MMB_VIT_GELU", port.vit_kernels.gelu)
    want = np.array(JViT(**KW_HEADS, dtype=jnp.bfloat16,
                         int8=fields.get("int8", False),
                         lnfold=fields.get("lnfold", False)).apply(
        {"params": params}, jnp.asarray(x)), np.float32)
    cos = torch.nn.functional.cosine_similarity(
        got, torch.from_numpy(want), dim=1)
    assert torch.isfinite(got).all() and float(cos.min()) >= 0.999, cos


def test_one_state_dict_serves_every_mode(toy):
    """The JAX package's parameter trees are the same in every mode, so
    one converted state dict loads into the port in each; the folds and
    codes follow a loaded state dict (the cache key holds the version)."""
    params, sd = toy
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    shapes = [jax.tree.map(lambda a: a.shape, jax.eval_shape(
        JViT(**KW, **m).init, jax.random.PRNGKey(0), x)["params"])
        for m in MODES.values()]
    assert all(s == shapes[0] for s in shapes)
    base = port_vit(sd).state_dict()
    for m in MODES.values():
        port = port_vit(sd, **m)
        st = port.state_dict()
        assert sorted(st) == sorted(base)
        assert all(torch.equal(v, base[k]) for k, v in st.items())
        with torch.no_grad():
            before = port(torch.from_numpy(images()))
            port.load_state_dict({k: v * 1.01 if "norm1" in k else v
                                  for k, v in st.items()})
            after = port(torch.from_numpy(images()))
        assert not torch.equal(before, after)


@pytest.mark.parametrize("mode,knob", [("int8", "MMB_VIT_INT8"),
                                       ("lnfold", "MMB_VIT_LNFOLD")])
def test_modes_refused_when_finetuning(mode, knob):
    cfg = ModelConfig(embedding_dim=16, vision=VisionConfig(
        vit_dino=True, finetune_cnn=True))
    with pytest.raises(ValueError, match=knob):
        VisionEncoder(cfg, device="cpu", kernels=KernelConfig(
            vit=ViTKernels(**{mode: True})))
    trunk = VisionTransformerDino(**KW, frozen=False, device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        trunk.vit_kernels = ViTKernels(**{mode: True})
    frozen = VisionTransformerDino(**KW, device="cpu",
                                   vit_kernels=ViTKernels(**{mode: True}))
    assert getattr(frozen.vit_kernels, mode)


def test_environment_changes_nothing(toy, monkeypatch):
    """The JAX package's environment knobs set: the port's model is built
    and runs as without them."""
    _, sd = toy
    x = torch.from_numpy(images())
    with torch.no_grad():
        want = port_vit(sd, torch.bfloat16)(x)
    for knob in ("MMB_VIT_INT8", "MMB_VIT_LNFOLD", "MMB_VIT_BLOCK",
                 "MMB_SPLIT_STEM", "MMB_S2D_STEM", "MMB_STEM_CPAD",
                 "MMB_AUG_CSPLIT", "MMB_FUSED_TRUNK", "MMB_FUSED_LSTM"):
        monkeypatch.setenv(knob, "1")
    monkeypatch.setenv("MMB_FUSED_ATTN", "qkv")
    monkeypatch.setenv("MMB_VIT_GELU", "tanh")
    port = port_vit(sd, torch.bfloat16)
    assert port.vit_kernels == ViTKernels() and KernelConfig() == \
        KernelConfig(vit=ViTKernels())
    with torch.no_grad():
        assert torch.equal(port(x), want)
