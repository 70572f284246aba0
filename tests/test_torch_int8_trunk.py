"""The port's int8 ResNeXt trunk and kernel plan against the JAX package on
the CPU: the plan rules (the int8-transport plans "t" and "t,t,1,1" among
them), the amax buffers and their weight bridge, the calibration, and the
whole trunk under ``trunk_int8=(0, 0, 1, 1)`` and the default plan (the
int8 CVCL train step is in ``tests/test_torch_int8_step.py``; the transport
trunks against JAX's in ``tests/test_torch_transport.py``).

The JAX side runs its fused trunk (``MMB_FUSED_TRUNK=1``,
``MMB_TRUNK_INT8=0,0,1,1``, set with ``monkeypatch``; the Pallas kernels in
interpret mode); the port runs its folded path's plain versions, which are
what its kernels compute on the card. Tolerances are stated where they are
used.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.api.convert import convert_cvcl_checkpoint
from multimodal_baby_tpu.models.quant_calib import (
    calibrate_backbone as j_calibrate)
from multimodal_baby_tpu.models.vision_resnext import ResNeXt50 as JResNeXt50
from multimodal_baby_tpu.ops import quant as JQ
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict, resnext50_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models import vision_resnext as TR
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.models.quant_calib import (
    calibrate_backbone, load_quant_scales)
from multimodal_baby_tpu_torch.models.vision_resnext import ResNeXt50

MIXED = (False, False, True, True)  # bench.py:117, the published recipe
COS_TOL = 0.999       # pooled per-row cosine, calibrated
CAL_RTOL = 1e-4       # calibrated amaxes: f32 conv paths, other orders


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU forwards on one intra-op thread: beside the other
    test workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def random_variables(size=64, seed=0):
    """ResNeXt-50 flax params and batch stats from numpy (He-normal convs,
    BN scale 1 + 0.1 N, bias, mean 0.1 N, var U(0.5, 2)): the tree shapes of
    JAX's init without running it. Made once per (size, seed) in a module
    (the tracing of JAX's init costs seconds a call); the tests only read
    them."""
    shapes = jax.eval_shape(JResNeXt50(dtype=jnp.bfloat16).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((2, size, size, 3)))
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            if k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                a = rng.randn(*v.shape) * np.sqrt(2 / fan_in)
            elif k == "scale":
                a = 1 + .1 * rng.randn(*v.shape)
            elif k == "var":
                a = rng.uniform(.5, 2., v.shape)
            else:
                a = .1 * rng.randn(*v.shape)
            out[k] = a.astype(np.float32)
        return out

    return fill(shapes["params"]), fill(shapes["batch_stats"])


def port_trunk(params, stats, trunk_int8=MIXED, plan=TR.DEFAULT_PLAN):
    trunk = ResNeXt50(torch.bfloat16, trunk_int8=trunk_int8, fused_plan=plan)
    sd = resnext50_state_dict(params, stats)
    sd.update({k: v.numpy() for k, v in trunk.state_dict().items()
               if k.endswith("amax")})
    load_state_dict(trunk, sd)
    return trunk


def row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def jax_fused_pooled(monkeypatch, params, stats, scales, x):
    monkeypatch.setenv("MMB_FUSED_TRUNK", "1")
    monkeypatch.setenv("MMB_TRUNK_INT8", "0,0,1,1")
    monkeypatch.delenv("MMB_TRUNK_PLAN", raising=False)
    model = JResNeXt50(dtype=jnp.bfloat16)
    pooled = jax.jit(lambda v, x: model.apply(v, x, train=False)["pooled"])
    return np.asarray(pooled(
        {"params": params, "batch_stats": stats, "quant_scales": scales},
        jnp.asarray(x).astype(jnp.bfloat16)), np.float32)


def jax_declared_scales(monkeypatch, x, plan="0,0,1,1"):
    """The "quant_scales" tree JAX's fused int8 trunk declares (zeros)."""
    monkeypatch.setenv("MMB_FUSED_TRUNK", "1")
    monkeypatch.setenv("MMB_TRUNK_INT8", plan)
    shapes = jax.eval_shape(
        lambda: JResNeXt50(dtype=jnp.bfloat16).init(
            jax.random.PRNGKey(0), jnp.asarray(x).astype(jnp.bfloat16)))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        shapes["quant_scales"])


# ----------------------------------------------------------------- plans

@pytest.mark.parametrize("raw", [
    False, True, MIXED, (0, 0, 1, 1), "0,0,1,1", "1", "0", "q", (0, 0, 0, 1),
    "0, 0, 1, 1", "t,t,1,1", "t", ("t", "t", "q", "q")])
def test_int8_plan_matches_jax(monkeypatch, raw):
    monkeypatch.delenv("MMB_TRUNK_INT8", raising=False)
    assert TR.parse_int8_plan(raw) == JResNeXt50(trunk_int8=raw)._int8_plan()


@pytest.mark.parametrize("raw,error", [
    ((True, False, True, True), ValueError),   # not a suffix
    ((True,), ValueError),                     # wrong length
    ("0,0,x,1", ValueError),                   # unknown entry
    ("t,0,t,1", ValueError)])                  # transport: a suffix too
def test_int8_plan_rejects(raw, error):
    with pytest.raises(error):
        TR.parse_int8_plan(raw)
    with pytest.raises(error):
        ResNeXt50(trunk_int8=raw)


@pytest.mark.parametrize("plan,ok", [
    (TR.DEFAULT_PLAN, True),
    (("banded", "splitband14", "split", "blocks"), True),
    (("banded7", "blocks", "full", "splitband"), True),
    (("banded28", "blocks", "split"), False),          # wrong length
    (("banded28", "blocks", "tiles", "full"), False),  # unknown mode
    (("banded0", "blocks", "split", "full"), False),   # empty band
    (("bandedx", "blocks", "split", "full"), False)])
def test_fused_plan_validation(plan, ok):
    if ok:
        assert TR.parse_fused_plan(plan) == tuple(plan)
    else:
        with pytest.raises(ValueError):
            ResNeXt50(fused_plan=plan)


def count_calls(monkeypatch):
    """Count the folded path's kernel calls by (kernel, kind): "bf16",
    "int8" (int8 codes and weights) or "t" (int8 codes, transport
    weights)."""
    calls = []

    def wrap(name, fn):
        def run(x, fw, *args, **kw):
            w1 = (fw if isinstance(fw, dict) else fw[0])["w1"]
            kind = ("bf16" if x.dtype != torch.int8 else
                    "int8" if w1.dtype == torch.int8 else "t")
            calls.append((name, kind))
            return fn(x, fw, *args, **kw)
        monkeypatch.setattr(TR, name, run)

    for name in ("fused_bottleneck", "fused_stage", "fused_stage_banded"):
        wrap(name, getattr(TR, name))
    return calls


@pytest.mark.parametrize("int8,plan,batch,want", [
    # the default plan under (0, 0, 1, 1): K3b, 4 K1, K2 + K3a, K3a
    (MIXED, TR.DEFAULT_PLAN, 32,
     [("fused_stage_banded", "bf16")] + [("fused_bottleneck", "bf16")] * 4
     + [("fused_bottleneck", "int8"), ("fused_stage", "int8"),
        ("fused_stage", "int8")]),
    # B % 32 != 0: the same plan all in bf16
    (MIXED, TR.DEFAULT_PLAN, 16,
     [("fused_stage_banded", "bf16")] + [("fused_bottleneck", "bf16")] * 4
     + [("fused_bottleneck", "bf16"), ("fused_stage", "bf16"),
        ("fused_stage", "bf16")]),
    # int8 stages demote banded -> blocks and splitband -> split; a band
    # that does not tile the rows (16 % 5) falls back to blocks
    (MIXED, ("banded5", "splitband4", "banded", "splitband"), 32,
     [("fused_bottleneck", "bf16")] * 3
     + [("fused_bottleneck", "bf16"), ("fused_stage_banded", "bf16")]
     + [("fused_bottleneck", "int8")] * 6
     + [("fused_bottleneck", "int8"), ("fused_stage", "int8")]),
    # "t,t,1,1": transport layers 1-2 (K3b, K1 in transport mode), then
    # int8 from the transport codes, with no quantization between
    ("t,t,1,1", TR.DEFAULT_PLAN, 32,
     [("fused_stage_banded", "t")] + [("fused_bottleneck", "t")] * 4
     + [("fused_bottleneck", "int8"), ("fused_stage", "int8"),
        ("fused_stage", "int8")]),
    # transport stages stay banded (vision_resnext.py:692-694)
    ("t", ("banded5", "splitband4", "banded", "splitband"), 32,
     [("fused_bottleneck", "t")] * 3
     + [("fused_bottleneck", "t"), ("fused_stage_banded", "t")]
     + [("fused_stage_banded", "t")]
     + [("fused_bottleneck", "t"), ("fused_stage_banded", "t")]),
    ("t", TR.DEFAULT_PLAN, 16,  # B % 32 != 0: bf16
     [("fused_stage_banded", "bf16")] + [("fused_bottleneck", "bf16")] * 4
     + [("fused_bottleneck", "bf16"), ("fused_stage", "bf16"),
        ("fused_stage", "bf16")]),
])
def test_plan_dispatch(monkeypatch, int8, plan, batch, want):
    """Which kernel each stage runs at 64 px (stem output 16 x 16)."""
    params, stats = random_variables()
    trunk = port_trunk(params, stats, trunk_int8=int8, plan=plan)
    calls = count_calls(monkeypatch)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        batch, 64, 64, 3).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        out = trunk.forward_folded(x)
    assert calls == want
    assert out["pooled"].dtype == torch.float32
    assert out["feature_map"].dtype == torch.bfloat16
    assert tuple(out["feature_map"].shape) == (batch, 2, 2, 2048)


@pytest.mark.parametrize("int8", [MIXED, "t,t,1,1", "t"])
def test_batch_off_32_computes_the_bf16_plan(int8):
    """JAX's rule (vision_resnext.py:570): an int8 plan runs all-bf16 when
    B % 32 != 0, so the result is the bf16 trunk's, bit for bit."""
    params, stats = random_variables()
    x = torch.from_numpy(np.random.RandomState(2).randn(
        8, 64, 64, 3).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = port_trunk(params, stats, trunk_int8=int8).forward_folded(x)
        want = port_trunk(params, stats, trunk_int8=False).forward_folded(x)
    for k in ("pooled", "feature_map"):
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------- buffers and bridge

@pytest.mark.parametrize("plan,n_amax", [
    ("0,0,1,1", 1 + 16 + 2 * 9), ("t,t,1,1", 1 + 16 + 2 * 9),
    ("t", 1 + 16)])
def test_amax_buffers_where_jax_declares_them(monkeypatch, plan, n_amax):
    """The port's amax buffers are JAX's "quant_scales" variables
    (stem_amax, out_amax on every block, h1/h2 on "q" blocks only: a
    transport block declares out_amax alone); a bf16 trunk has none, so
    its state dict is unchanged."""
    params, stats = random_variables()
    scales = jax_declared_scales(monkeypatch, np.zeros((32, 64, 64, 3)),
                                 plan)
    want = sorted(k for k in resnext50_state_dict(params, stats,
                                                  quant_scales=scales)
                  if k.endswith("amax"))
    got = sorted(k for k in ResNeXt50(trunk_int8=plan).state_dict()
                 if k.endswith("amax"))
    assert got == want and len(got) == n_amax
    assert not any(k.endswith("amax")
                   for k in ResNeXt50().state_dict())


@pytest.mark.parametrize("plan", ["0,0,1,1", "t,t,1,1", "t"])
def test_quant_scales_bridge_round_trip(monkeypatch, plan):
    """The port's state dict -> JAX's convert_cvcl_checkpoint -> with JAX's
    "quant_scales" collection -> cvcl_state_dict -> the port: every amax
    lands in its buffer exactly, and the fold is redone."""
    rng = np.random.RandomState(3)
    scales = jax.tree.map(
        lambda z: rng.uniform(.5, 4., z.shape).astype(np.float32),
        jax_declared_scales(monkeypatch, np.zeros((32, 64, 64, 3)), plan))
    cfg = tcfg.ModelConfig(
        embedding_dim=32, vocab_size=64, embedding_type="flat",
        vision=tcfg.VisionConfig(frozen_bn="running", trunk_int8=plan),
        text=tcfg.TextConfig(text_encoder="embedding"))
    model = CVCL(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("amax")}
    params, stats = convert_cvcl_checkpoint(sd, "embedding", tie=cfg.tie)
    trunk = model.vision_encoder.model
    before = trunk.folded(torch.float32)
    load_state_dict(model, cvcl_state_dict(
        params, stats, quant_scales={"vision_encoder": {"backbone": scales}}))
    assert float(trunk.stem_amax) == float(scales["stem_amax"])
    for name, block in scales.items():
        if name == "stem_amax":
            continue
        tb = trunk.get_submodule(name.replace("_", "."))
        for k, v in block.items():
            assert float(getattr(tb, k)) == float(v), (name, k)
    for k, v in sd.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, k)
    assert trunk.folded(torch.float32) is not before


def test_calibration_matches_jax():
    params, stats = random_variables()
    x = np.random.RandomState(4).randn(4, 64, 64, 3).astype(np.float32)
    want = j_calibrate(params, stats, jnp.asarray(x))
    trunk = port_trunk(params, stats)
    got = calibrate_backbone(trunk, torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        for n, t in (v.items() if isinstance(v, dict) else [("", v)]):
            w = want[k][n] if n else want[k]
            np.testing.assert_allclose(float(t), float(w), rtol=CAL_RTOL,
                                       err_msg=f"{k} {n}")
    load_quant_scales(trunk, got)
    assert float(trunk.layer3[2].h2_amax) == float(got["layer3_2"]["h2_amax"])
    assert float(trunk.layer1[0].out_amax) == float(
        got["layer1_0"]["out_amax"])
    assert not hasattr(trunk.layer1[0], "h1_amax")  # a bf16 stage's block


# ------------------------------------------------------------ the trunk

def test_int8_trunk_matches_jax_calibrated(monkeypatch):
    """The published plan at 64 px, B = 32, calibrated on the batch: pooled
    per-row cosine >= 0.999 against JAX's fused int8 trunk (both run layers
    1-2 in bf16, whose rounding differs between the packages, and quantize
    the same way after it)."""
    params, stats = random_variables()
    x = np.random.RandomState(5).randn(32, 64, 64, 3).astype(np.float32)
    trunk = port_trunk(params, stats)
    # one calibration for both (the two agree: test_calibration_matches_jax)
    scales = calibrate_backbone(trunk, torch.from_numpy(x))
    load_quant_scales(trunk, scales)
    want = jax_fused_pooled(monkeypatch, params, stats,
                            jax.tree.map(np.asarray, scales), x)
    with torch.no_grad():
        got = trunk.forward_folded(torch.from_numpy(x).to(torch.bfloat16))
    assert got["pooled"].shape == want.shape
    cos = row_cos(got["pooled"].numpy(), want)
    assert cos.min() >= COS_TOL, cos.min()


def test_int8_trunk_matches_jax_uncalibrated():
    """Uncalibrated (every amax 0): the BatchNorm-bound chain. The ranges at
    the bf16 -> int8 boundary and at the output equal JAX's chain
    (vision_resnext.py:242-250, 679-683; rtol 1e-6, sums of f32 bounds),
    and so does the fold of the first int8 block, which takes the boundary
    range: its scale vectors to 1e-6 of their largest element, its weights
    to one code in fewer than 1e-5 of them (an ulp of rsqrt can move a
    weight across a rounding). The pooled features are not held against
    JAX's here: the bound chain puts the output range near 90 where the
    activations are near 1, so a few codes carry the features, and the bf16
    rounding of layers 1-2 alone moves the port's own pooled features to
    cosine 0.975 (bf16 against f32 input, 32 px, B = 32)."""
    params, stats = random_variables(size=32, seed=6)
    x = np.random.RandomState(7).randn(32, 32, 32, 3).astype(np.float32)
    trunk = port_trunk(params, stats)
    with torch.no_grad():
        got = trunk.forward_folded(torch.from_numpy(x).to(torch.bfloat16))
    assert torch.isfinite(got["pooled"]).all()
    entry, out = trunk._fold_amax

    amax = JQ.resolve_amax(jnp.float32(0), params["bn1"])
    for stage, (_, n_blocks, _) in enumerate(TR.RESNEXT50_STAGES, start=1):
        for b in range(n_blocks):
            p = params[f"layer{stage}_{b}"]
            new = JQ.bn_amax_bound(p["bn3"]) + amax
            if (stage, b) == (3, 0):
                want_entry = amax
                want_fold = JQ.fold_block_params_q(
                    p, stats["layer3_0"], amax,
                    JQ.resolve_amax(jnp.float32(0), p["bn1"]),
                    JQ.resolve_amax(jnp.float32(0), p["bn2"]), new)
            amax = new
    np.testing.assert_allclose(float(entry), float(want_entry), rtol=1e-6)
    np.testing.assert_allclose(float(out), float(amax), rtol=1e-6)
    fw = trunk.folded(torch.bfloat16, trunk.int8_plan)[7][0]  # layer3.0
    for k in ("a1", "b1", "a3", "b3", "ad", "bd"):
        want = np.asarray(want_fold[k])
        np.testing.assert_allclose(fw[k].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    for k in ("w1", "w3", "wd"):  # the port's are output-major
        diff = np.abs(fw[k].numpy().astype(int)
                      - np.asarray(want_fold[k]).T.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-5, k
