"""The train and eval steps with the split stem (the JAX package's
``MMB_SPLIT_STEM=1``, set with monkeypatch for the JAX side alone): the
augment hands a ResNeXt trunk the space-to-depth layout and the trunk
takes its 4x4 stem. test_torch_cvcl's model and weights (ResNeXt-50 at
full width, a 32-d head, the embedding text encoder, f32) on two 32 px
uint8 frames, which the augment (off, the recipe's default) resizes to
224 px: the loss and the head gradients of one train step, and the eval
loss, against JAX's at rtol 1e-5 (test_torch_cvcl's STEP_RTOL).
"""

import numpy as np
import pytest
import torch

import jax

from multimodal_baby_tpu.train.step import make_loss_fn as j_make_loss_fn
from multimodal_baby_tpu_torch.api.convert import cvcl_state_dict
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_eval_step, make_train_step)
from test_torch_cvcl import (
    STEP_RTOL, build_pair, jax_batch, make_batch, make_cfg, rel_err)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread: beside the other test
    workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def u8_batch(seed=5, b=2):
    """The first ``b`` rows of test_torch_cvcl's batch, with uint8 frames
    in place of the normalized images (the augment resizes them to 224
    px)."""
    rng = np.random.RandomState(seed)
    batch = {k: v[:b] for k, v in make_batch(seed).items() if k != "image"}
    batch["image_u8"] = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    return batch


@pytest.fixture(scope="module")
def split_pair():
    return build_pair(make_cfg())


def test_split_stem_steps_match_jax(split_pair, monkeypatch):
    """MMB_SPLIT_STEM=1: the augment (off, as the recipe's default) emits
    the space-to-depth layout and the trunk takes the 4x4 stem, in the
    train step and the eval step alike. The frames are f32, as the f32
    model's (the JAX package's f32 trunk leaves a bf16 input as it is, and
    its 4x4 stem then casts the weight to bf16, where its 7x7 promotes to
    f32)."""
    model, params, stats, pair_port = split_pair
    cfg = make_cfg()
    cfg.parallel.compute_dtype = "float32"
    tcfg_ = tcfg.ExperimentConfig.from_json(cfg.to_json())
    port = CVCL(tcfg_.model, device="cpu",
                kernels=KernelConfig(split_stem=True))
    port.load_state_dict(pair_port.state_dict())
    batch = u8_batch()
    monkeypatch.setenv("MMB_SPLIT_STEM", "1")
    loss_fn = j_make_loss_fn(model, cfg)
    (want_loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, stats, jax_batch(batch), jax.random.PRNGKey(0), True)
    want_eval, _ = loss_fn(params, stats, jax_batch(batch),
                           jax.random.PRNGKey(0), False)

    trunk = port.vision_encoder.model
    seen = []
    real = trunk._stem_from_s2d
    trunk._stem_from_s2d = lambda xs: seen.append(xs.shape) or real(xs)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    got_eval = make_eval_step(port, tcfg_)(tb)["loss"]
    metrics = make_train_step(port, tcfg_)(init_train_state(port, tcfg_), tb)
    assert seen == [(2, 12, 112, 112)] * 2
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(float(got_eval), float(want_eval),
                               rtol=STEP_RTOL)
    want_grads = cvcl_state_dict(jax.tree.map(np.asarray, grads), stats)
    checked = 0
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert rel_err(p.grad, want_grads[name]) < STEP_RTOL, name
            checked += 1
    assert checked == 4
