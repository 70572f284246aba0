"""The port's five-call API against the JAX package's, on one reference-
format Lightning ``.ckpt`` loaded by both packages.

The checkpoints are built here as the reference writes them: a torchvision-
layout ResNeXt-50 (``nn.BatchNorm2d``: ``num_batches_tracked`` included,
running statistics perturbed) with a Linear head (flat) or wrapped in a
Sequential with a 1x1 conv head (spatial, indices renamed), an embedding
text encoder, a learned-temperature entry and a tied LM head with its
bias. The JAX package loads them with
``CVCLModel.from_torch_checkpoint``, the port with ``load_model`` on the
CPU, both in f32. Images at 64 px.

Tolerances (f32, other convolution and summation orders): image features
atol 1e-5, text features atol 1e-6, logits (x 1/0.07) atol 2e-4.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

from multimodal_baby_tpu.api import model as japi
from multimodal_baby_tpu_torch.api import model as tapi
from multimodal_baby_tpu_torch.api.convert import reference_state_dict
from multimodal_baby_tpu_torch.core.config import ModelConfig
from tests.test_vision import _TorchResNeXt50

E = 64
SPATIAL_IDX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
               "layer3": "6", "layer4": "7"}
FEAT_ATOL, TEXT_ATOL, LOGIT_ATOL = 1e-5, 1e-6, 2e-4


def make_ckpt(path, spatial, sim="max", seed=0):
    torch.manual_seed(seed)
    trunk = _TorchResNeXt50()
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 2.0)
                m.num_batches_tracked.fill_(100)
    embedding = tnn.Embedding(2350, E, padding_idx=0)
    sd = {}
    for k, v in trunk.state_dict().items():
        if spatial:
            top, _, rest = k.partition(".")
            k = f"{SPATIAL_IDX[top]}.{rest}"
        sd[f"vision_encoder.model.{k}"] = v
    if spatial:
        head = tnn.Conv2d(2048, E, 1)
        sd["vision_encoder.model.8.weight"] = head.weight.detach()
        sd["vision_encoder.model.8.bias"] = head.bias.detach()
    else:
        head = tnn.Linear(2048, E)
        sd["vision_encoder.model.fc.weight"] = head.weight.detach()
        sd["vision_encoder.model.fc.bias"] = head.bias.detach()
    sd["text_encoder.embedding.weight"] = embedding.weight.detach()
    sd["model.logit_neg_log_temperature"] = torch.tensor(2.0)
    sd["language_model.output_layer.weight"] = embedding.weight.detach()
    sd["language_model.output_layer.bias"] = torch.zeros(2350)
    torch.save({"state_dict": sd, "hyper_parameters": {
        "text_encoder": "embedding", "embedding_dim": E,
        "embedding_type": "spatial" if spatial else "flat", "sim": sim,
        "normalize_features": True, "fix_temperature": True,
        "temperature": 0.07, "cnn_dino": True, "vit_dino": False,
        "tie": True, "bias": True}}, path)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {"flat": make_ckpt(root / "flat.ckpt", False),
            "spatial": make_ckpt(root / "spatial.ckpt", True, "mean", 1)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return rng.randn(2, 64, 64, 3).astype(np.float32)


def both(path):
    jm = japi.CVCLModel.from_torch_checkpoint(path)
    tm, prep = tapi.load_model(str(path), device="cpu")
    assert prep is tapi.preprocess
    return jm, tm


def test_five_calls_match_jax_flat(ckpts, inputs):
    jm, tm = both(ckpts["flat"])
    texts = ["ball", "a cat", "the kitty's ball!"]
    j_tok, j_len = jm.tokenize(texts)
    t_tok, t_len = tm.tokenize(texts)
    assert t_tok.dtype == torch.long and t_tok.device.type == "cpu"
    np.testing.assert_array_equal(t_tok.numpy(), j_tok)
    np.testing.assert_array_equal(t_len.numpy(), j_len)

    t_img = tm.encode_image(inputs)
    assert isinstance(t_img, torch.Tensor) and t_img.shape == (2, E)
    np.testing.assert_allclose(t_img.numpy(),
                               np.asarray(jm.encode_image(inputs)),
                               atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(t_img.norm(dim=1).numpy(), 1.0, atol=1e-5)
    # tensors in, and the default lengths (non-pad count)
    t_txt = tm.encode_text(torch.from_numpy(np.asarray(j_tok)))
    np.testing.assert_allclose(
        t_txt.numpy(), np.asarray(jm.encode_text(j_tok, j_len)),
        atol=TEXT_ATOL, rtol=0)
    for got, want in zip(tm(inputs, t_tok, t_len),
                         jm(inputs, j_tok, j_len)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    lpi, lpt = tm(inputs, t_tok, t_len)
    torch.testing.assert_close(lpi, (t_img @ t_txt.T) / 0.07, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(lpt, lpi.T, rtol=0, atol=0)


def test_five_calls_match_jax_spatial(ckpts, inputs):
    """The spatial variant: Sequential indices renamed, the 1x1 conv head
    as the Linear ``fc``, the mean similarity over [2, 2, 2, E] maps."""
    jm, tm = both(ckpts["spatial"])
    tokens, lens = tm.tokenize(["ball", "a cat"])
    t_txt = tm.encode_text(tokens, lens)
    assert t_txt.shape == (2, 25, E)  # per-token features
    np.testing.assert_allclose(
        t_txt.numpy(), np.asarray(jm.encode_text(tokens.numpy(),
                                                 lens.numpy())),
        atol=TEXT_ATOL, rtol=0)
    for got, want in zip(tm(inputs, tokens, lens),
                         jm(inputs, tokens.numpy(), lens.numpy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    assert tm.encode_image(inputs).shape == (2, 2, 2, E)


def test_reference_state_dict_drops_what_the_config_says():
    sd = {"vision_encoder.model.conv1.weight": torch.zeros(1),
          "vision_encoder.model.bn1.num_batches_tracked": torch.tensor(3),
          "model.logit_neg_log_temperature": torch.tensor(2.0),
          "language_model.output_layer.weight": torch.zeros(2),
          "language_model.output_layer.bias": torch.zeros(2)}
    kept = reference_state_dict(sd, ModelConfig(fix_temperature=True))
    assert sorted(kept) == ["language_model.output_layer.bias",
                            "vision_encoder.model.conv1.weight"]
    kept = reference_state_dict(sd, ModelConfig(
        fix_temperature=False, tie=False, bias=False))
    assert sorted(kept) == ["language_model.output_layer.weight",
                            "model.logit_neg_log_temperature",
                            "vision_encoder.model.conv1.weight"]


def test_preprocess_matches_jax():
    from PIL import Image
    img = Image.fromarray(np.random.RandomState(1).randint(
        0, 255, (300, 400, 3), np.uint8))
    np.testing.assert_array_equal(tapi.preprocess(img),
                                  japi.preprocess(img))


def test_load_model_refusals(ckpts, tmp_path):
    with pytest.raises(RuntimeError, match="Hugging Face"):
        tapi.load_model("cvcl", device="cpu")
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        tapi.load_model(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not found"):
        tapi.load_model(str(tmp_path / "missing.ckpt"), device="cpu")
    if not torch.cuda.is_available():  # the entry point builds on the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.load_model(str(ckpts["flat"]))
