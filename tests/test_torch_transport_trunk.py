"""The port's int8-transport ResNeXt trunks, ``trunk_int8="t"`` and
``"t,t,1,1"``, against the JAX package's fused trunk on the CPU.

The JAX side runs its fused trunk (``MMB_FUSED_TRUNK=1`` and
``MMB_TRUNK_INT8`` set with ``monkeypatch``; the Pallas kernels in
interpret mode, about 40 s a plan), the port its folded path's plain
versions, which are what its kernels compute on the card, on the same
numpy-seeded weights and one calibration. The gate is the pooled per-row
cosine >= 0.999 of ``tests/test_torch_int8_trunk.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models.vision_resnext import ResNeXt50 as JResNeXt50
from multimodal_baby_tpu_torch.models.quant_calib import (
    calibrate_backbone, load_quant_scales)

from test_torch_int8_trunk import port_trunk, random_variables, row_cos

COS_TOL = 0.999


@pytest.mark.parametrize("plan", ["t", "t,t,1,1"])
def test_transport_trunk_matches_jax(monkeypatch, plan):
    """The whole trunk at 64 px (tests/test_quant_trunk.py:295-331), B = 32,
    the default kernel plan, one calibration (the port's, on the batch) for
    both: pooled per-row cosine >= 0.999 against JAX's fused trunk. Each
    package rounds its bf16 products its own way, so each moves some codes
    across a rounding of every block's output: the two are equally far
    from the f32 conv path, and their distance is the sum of both. At
    32 px the pool averages a single pixel and that sum reaches 0.9989."""
    params, stats = random_variables(size=64, seed=9)
    x = np.random.RandomState(10).randn(32, 64, 64, 3).astype(np.float32)
    trunk = port_trunk(params, stats, trunk_int8=plan)
    scales = calibrate_backbone(trunk, torch.from_numpy(x))
    load_quant_scales(trunk, scales)
    with torch.no_grad():
        got = trunk.forward_folded(torch.from_numpy(x).to(torch.bfloat16))
    # JAX declares only the ranges its plan uses
    jscales = jax.tree.map(np.asarray, scales)
    if plan == "t":
        jscales = {k: ({"out_amax": v["out_amax"]} if isinstance(v, dict)
                       else v) for k, v in jscales.items()}
    else:
        jscales = {k: ({"out_amax": v["out_amax"]}
                       if isinstance(v, dict) and k[5] in "12" else v)
                   for k, v in jscales.items()}
    monkeypatch.setenv("MMB_FUSED_TRUNK", "1")
    monkeypatch.setenv("MMB_TRUNK_INT8", plan)
    monkeypatch.delenv("MMB_TRUNK_PLAN", raising=False)
    model = JResNeXt50(dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda v, x: model.apply(v, x, train=False)["pooled"])(
            {"params": params, "batch_stats": stats,
             "quant_scales": jscales},
            jnp.asarray(x).astype(jnp.bfloat16)), np.float32)
    assert got["pooled"].shape == want.shape
    assert torch.isfinite(got["pooled"]).all()
    cos = row_cos(got["pooled"].numpy(), want)
    assert cos.min() >= COS_TOL, cos.min()
