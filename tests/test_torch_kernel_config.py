"""The kernel configuration (``models/kernel_config.py``) and its way in:
the flags of every entry point that builds a model, named after the JAX
package's environment knobs, parse to one ``KernelConfig``; unknown values
raise; ``Trainer``, ``load_model`` and each CLI hand it to the model; the
defaults are the JAX package's; ``fused_trunk`` forces the ResNeXt's
folded path on or off (``MMB_FUSED_TRUNK``).
"""

import argparse

import pytest
import torch

from multimodal_baby_tpu.models import vision_vit as jvit
from multimodal_baby_tpu.models.vision_resnext import ResNeXt50 as JResNeXt50
from multimodal_baby_tpu_torch.api import model as tapi
from multimodal_baby_tpu_torch.cli import analyze, eval as teval
from multimodal_baby_tpu_torch.cli import linear_decoding, parity
from multimodal_baby_tpu_torch.cli import train as ttrain
from multimodal_baby_tpu_torch.cli.args import (
    add_kernel_args, kernel_config_from_args)
from multimodal_baby_tpu_torch.models.kernel_config import KernelConfig
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50
from multimodal_baby_tpu_torch.models.vision_vit import ViTKernels
from test_torch_api import make_ckpt
from test_torch_cli_train import smoke_argv

# every flag with a value other than its default, and what it means
FLAGS = ["--trunk_plan", "blocks,blocks,split,full", "--fused_trunk", "0",
         "--fused_attn", "2", "--vit_mlp", "", "--vit_block", "1",
         "--vit_gelu", "tanh", "--vit_int8", "1", "--vit_lnfold", "1",
         "--fused_lstm", "1", "--s2d_stem", "1", "--stem_cpad", "1",
         "--split_stem", "1", "--aug_csplit", "1"]
WANT = KernelConfig(
    trunk_plan=("blocks", "blocks", "split", "full"), fused_trunk=False,
    vit=ViTKernels(attn="pairs", mlp="off", whole_block=True, gelu="tanh",
                   int8=True, lnfold=True),
    fused_lstm=True, stem="s2d", stem_cpad=True, split_stem=True,
    aug_csplit=True)


def parse(argv):
    parser = argparse.ArgumentParser()
    add_kernel_args(parser)
    return kernel_config_from_args(parser.parse_args(argv))


def test_flags_parse_to_the_value():
    assert parse(FLAGS) == WANT
    assert parse([]) == KernelConfig()
    assert parse(["--fused_trunk", "1", "--fused_lstm", "0"]) == \
        KernelConfig(fused_trunk=True, fused_lstm=False)
    with pytest.raises(ValueError):
        parse(["--trunk_plan", "blocks,blocks,blocks"])


def test_defaults_are_the_jax_packages():
    k = KernelConfig()
    assert k.trunk_plan == JResNeXt50.fused_plan
    assert (k.vit.attn, k.vit.mlp) == (jvit._ATTN_DEFAULT, jvit._MLP_DEFAULT)
    assert k.vit == ViTKernels() and not (k.vit.whole_block or k.vit.int8
                                          or k.vit.lnfold)
    assert k.vit.gelu == "erf" and k.fused_trunk is None
    assert k.fused_lstm is None and k.stem == "conv7"
    assert not (k.stem_cpad or k.split_stem or k.aug_csplit)


@pytest.mark.parametrize("flag,value", [
    ("--fused_trunk", "yes"), ("--fused_attn", "blocks"), ("--vit_mlp", "1"),
    ("--vit_block", "true"), ("--vit_gelu", "relu"), ("--vit_int8", "2"),
    ("--fused_lstm", "on"), ("--s2d_stem", "s2d"), ("--split_stem", "")])
def test_unknown_flag_values_are_refused(flag, value):
    with pytest.raises(SystemExit):
        parse([flag, value])


@pytest.mark.parametrize("field,value", [
    ("trunk_plan", "blocks,blocks,blocks"), ("trunk_plan", "a,b,c,d"),
    ("fused_trunk", 1), ("fused_trunk", "1"), ("vit", "block"),
    ("fused_lstm", "1"), ("stem", "S2D"), ("stem_cpad", 1),
    ("split_stem", None), ("aug_csplit", "0")])
def test_unknown_values_raise(field, value):
    with pytest.raises(ValueError):
        KernelConfig(**{field: value})


def test_trainer_and_load_model_pass_it_on(tmp_path):
    """cli/train builds the Trainer's model in the flags' configuration
    (one epoch on the toy trunk, the augment on in its per-channel form);
    load_model hands a checkpoint directory's model the one it is given,
    and the default when given none."""
    trainer = ttrain.make_trainer(smoke_argv(
        tmp_path, "--exp_name", "k", "--augment_frames", *FLAGS))
    assert trainer.model.kernels == WANT
    assert trainer.model.text_encoder.fused_lstm is True
    trainer.fit()
    ckdir = tmp_path / "k"
    model, _ = tapi.load_model(str(ckdir), device="cpu", kernels=WANT)
    assert model.model.kernels == WANT
    model, _ = tapi.load_model(str(ckdir), device="cpu")
    assert model.model.kernels == KernelConfig()


def test_load_model_builds_the_trunk_in_it(tmp_path):
    """A reference checkpoint's ResNeXt takes the plan, the folded-path
    rule and the stem (cpad changes no sum: the same features)."""
    path = make_ckpt(tmp_path / "flat.ckpt", False)
    kernels = KernelConfig(trunk_plan=("blocks", "blocks", "blocks", "full"),
                           fused_trunk=False, stem_cpad=True)
    model, _ = tapi.load_model(str(path), device="cpu", kernels=kernels)
    trunk = model.model.vision_encoder.model
    assert trunk.fused_plan == ("blocks", "blocks", "blocks", "full")
    assert trunk.fused_trunk is False and trunk.stem_cpad
    base, _ = tapi.load_model(str(path), device="cpu")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    got, want = model.encode_image(x), base.encode_image(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


class Loaded(Exception):
    """Raised by the stub load_model: the CLI got as far as loading."""


@pytest.mark.parametrize("cli,argv", [
    (teval.main, ["--checkpoint", "c"]),
    (linear_decoding.main, ["--checkpoint", "c"]),
    (parity.main, ["--checkpoint", "c"]),
    (analyze.main, ["alignment", "--checkpoint", "c", "--eval_frames_dir",
                    "f"]),
    (analyze.main, ["duplicates", "--checkpoint", "c"])])
def test_every_cli_hands_it_to_load_model(cli, argv, monkeypatch):
    seen = []

    def load_model(path, device="cuda", kernels=None):
        seen.append((path, device, kernels))
        raise Loaded

    monkeypatch.setattr(tapi, "load_model", load_model)
    with pytest.raises(Loaded):
        cli(argv + ["--device", "cpu", *FLAGS])
    with pytest.raises(Loaded):
        cli(argv)
    assert seen == [("c", "cpu", WANT), ("c", "cuda", KernelConfig())]
    with pytest.raises(SystemExit):
        cli(argv + ["--vit_int8", "yes"])


def test_fused_trunk_forces_the_path(monkeypatch):
    """None: the folded path on CUDA only; True: wherever it applies (on
    the CPU through the kernels' plain versions), refused where it cannot
    (f32, a fine-tuned trunk, BN on batch statistics); False: never."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 64, 3, generator=g)
    paths = []
    for mode in (None, True, False):
        trunk = ResNeXt50(torch.bfloat16, device="cpu", fused_trunk=mode,
                          generator=torch.Generator().manual_seed(1))
        monkeypatch.setattr(trunk, "forward_folded",
                            lambda x: paths.append("folded"))
        monkeypatch.setattr(trunk, "forward_conv",
                            lambda x, train: paths.append("conv"))
        trunk(x)
        if mode:
            with pytest.raises(ValueError, match="MMB_FUSED_TRUNK"):
                trunk(x, train=True)
    assert paths == ["conv", "folded", "conv"]
    for kw in (dict(dtype=None), dict(dtype=torch.bfloat16, frozen=False)):
        with pytest.raises(ValueError, match="MMB_FUSED_TRUNK"):
            ResNeXt50(device="cpu", fused_trunk=True, **kw)
