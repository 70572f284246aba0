"""The port's backbone loading (``api/backbones.py``) against the JAX
package's, on local checkpoints written from seeded trunks.

The checkpoints nest and prefix their tensors as DINO's do (``teacher``,
``module.``, ``backbone.``, with a projection head left beside the trunk)
or as other trainers save them. Checks: name parsing and its errors; the
unwrap and prefix strip; the port's loaded state dict against the JAX
package's ``convert_resnext50`` and ``convert_vit`` outputs mapped back
through the port's ``api/convert.py`` (arrays only: no forward, a
full-width ResNeXt-50 forward on the CPU costs minutes); ``load_backbone``
into a CVCL's trunk; the hub refusal.
"""

import numpy as np
import pytest
import torch

from multimodal_baby_tpu.api import backbones as jbb
from multimodal_baby_tpu_torch.api import backbones as tbb
from multimodal_baby_tpu_torch.api.convert import (
    resnext50_state_dict, vit_state_dict)
from multimodal_baby_tpu_torch.core.config import (
    ModelConfig, TextConfig, VisionConfig)
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50
from multimodal_baby_tpu_torch.models.vision_vit import vit_base


def dino_nest(sd, head=True):
    """DINO's layout: {"teacher": {"module.backbone.<k>": ...}} beside the
    student and the epoch, with the DINO projection head."""
    inner = {f"module.backbone.{k}": v for k, v in sd.items()}
    if head:
        inner["module.head.mlp.0.weight"] = torch.ones(4, 3)
        inner["module.head.last_layer.weight_g"] = torch.ones(4, 1)
    return {"teacher": inner, "student": {"x": torch.zeros(1)}, "epoch": 7}


NESTINGS = {
    "dino": dino_nest,
    "state_dict": lambda sd: {"state_dict": {f"module.{k}": v
                                             for k, v in sd.items()}},
    "model_state_dict": lambda sd: {"model_state_dict": dict(sd),
                                    "optimizer": {}},
    "plain": lambda sd: dict(sd),
}


@pytest.fixture(scope="module")
def trunks(tmp_path_factory):
    root = tmp_path_factory.mktemp("backbones")
    gen = torch.Generator().manual_seed(0)
    resnext = ResNeXt50(device="cpu", generator=gen).state_dict()
    # a checkpoint also carries BN's counters and the classifier
    resnext["bn1.num_batches_tracked"] = torch.tensor(3)
    resnext["fc.weight"] = torch.randn(10, 2048, generator=gen)
    vit = vit_base(device="cpu", generator=gen).state_dict()
    paths = {}
    for name, sd in (("dino_sfp_resnext50", resnext),
                     ("dino_sfp_vitb14", vit)):
        paths[name] = root / f"{name}.pth"
        torch.save(dino_nest(sd), paths[name])
    return {"root": root, "paths": paths, "resnext": resnext, "vit": vit}


@pytest.mark.parametrize("name", [
    "dino_sfp_resnext50", "dino_say_vitb14", "mugs_s_vitl16",
    "mae_sfp_vitb16", "dino_s_vits16", "dino_sfp_resnext50_extra"])
def test_parse_backbone_name_matches_jax(name):
    if name.endswith("_extra"):
        for mod in (tbb, jbb):
            with pytest.raises(AssertionError, match="architecture"):
                mod.parse_backbone_name(name)
        return
    assert tbb.parse_backbone_name(name) == jbb.parse_backbone_name(name)
    assert tbb.SPEC_TO_ARCH == jbb.SPEC_TO_ARCH


@pytest.mark.parametrize("name,error", [
    ("simclr_sfp_resnext50", AssertionError), ("dino_resnext50", ValueError),
    ("dino_sfp_vitb99", AssertionError)])
def test_parse_backbone_name_errors(name, error):
    for mod in (tbb, jbb):
        with pytest.raises(error):
            mod.parse_backbone_name(name)


@pytest.mark.parametrize("nesting", sorted(NESTINGS))
def test_prefix_strip_matches_jax(tmp_path, nesting):
    """The same unwrapped keys and tensors as the JAX package's loader."""
    gen = torch.Generator().manual_seed(1)
    sd = {"conv1.weight": torch.randn(4, 3, 7, 7, generator=gen),
          "layer1.0.bn1.running_var": torch.rand(4, generator=gen),
          "blocks.0.attn.qkv.bias": torch.randn(6, generator=gen)}
    path = tmp_path / "x.pth"
    torch.save(NESTINGS[nesting](sd), path)
    got = tbb.load_backbone_state_dict("dino_sfp_resnext50", str(path))
    want = jbb.load_backbone_state_dict("dino_sfp_resnext50", str(path))
    assert list(got) == list(want)
    assert set(sd) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_resnext50_matches_jax_convert(trunks):
    """The port's (arch, state dict) equals the JAX package's converted
    trees mapped back with ``resnext50_state_dict``: the same 265 keys
    (no classifier, no BN counter, no DINO head) and arrays."""
    path = str(trunks["paths"]["dino_sfp_resnext50"])
    arch, sd = tbb.load_backbone_params("dino_sfp_resnext50", path)
    jarch, params, stats = jbb.load_backbone_params("dino_sfp_resnext50",
                                                    path)
    want = resnext50_state_dict(params, stats)
    assert arch == jarch == "resnext50"
    assert sorted(sd) == sorted(want) and len(sd) == 265
    for k, v in want.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_vit_matches_jax_convert(trunks):
    path = str(trunks["paths"]["dino_sfp_vitb14"])
    arch, sd = tbb.load_backbone_params("dino_sfp_vitb14", path)
    jarch, params, stats = jbb.load_backbone_params("dino_sfp_vitb14", path)
    want = vit_state_dict(params)
    assert arch == jarch == "vit_base" and stats == {}
    assert sorted(sd) == sorted(want) == sorted(trunks["vit"])
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("vit", [False, True])
def test_load_backbone_into_cvcl(trunks, vit):
    """load_backbone fills a CVCL's trunk with the checkpoint's tensors
    (an int8 plan's amax buffers and the projection head keep theirs)."""
    cfg = ModelConfig(embedding_dim=16, vocab_size=20,
                      vision=VisionConfig(vit_dino=vit, trunk_int8="0,0,1,1"),
                      text=TextConfig(text_encoder="embedding"))
    model = CVCL(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(5))
    trunk = model.vision_encoder.model
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    name = "dino_sfp_vitb14" if vit else "dino_sfp_resnext50"
    src = tbb.load_backbone_params(name, str(trunks["paths"][name]))[1]
    assert tbb.load_backbone(model, name, str(trunks["paths"][name])) == (
        "vit_base" if vit else "resnext50")
    after = trunk.state_dict()
    kept = [k for k in after if k not in src]
    assert kept and all(k.startswith(("fc.", "head.")) or
                        k.endswith("_amax") for k in kept)
    for k, v in after.items():
        assert torch.equal(v, before[k] if k in kept else src[k]), k
    with pytest.raises(KeyError, match="does not fit"):
        tbb.load_backbone(model, "dino_sfp_vitb14" if not vit
                          else "dino_sfp_resnext50",
                          str(trunks["paths"]["dino_sfp_vitb14" if not vit
                                              else "dino_sfp_resnext50"]))


def test_hub_refused(trunks):
    with pytest.raises(RuntimeError, match="Hugging Face hub"):
        tbb.load_backbone_params("dino_sfp_resnext50")
    with pytest.raises(KeyError, match="lacks"):
        tbb.load_backbone_params("dino_sfp_vitb14",
                                 str(trunks["paths"]["dino_sfp_resnext50"]))
