"""The CLIP cell (``clip_l14_train_b256``: ``loops/clip_train.py``,
``reference/clip_vit_l14.py``, ``reference/text_clip.py``,
``counters/clip_vit_l14.py``, ``counters/text_clip.py``) rehearsed whole
on the CPU at a tiny size: the result's keys and metrics with and
without a trace, the control and the faults failing, the configuration
held to the program's CLIP and to the reference's widths, the counts,
the captions, and no module of JAX loaded."""

import copy
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.counters import clip_vit_l14 as counters
from benchmark.loops import clip_train
from benchmark.reference import clip_vit_l14 as ref
from benchmark.reference import text_clip
from benchmark.tests import tiny

CELL = "clip_l14_train_b256"
SIZES = dict(image_px=tiny.PX, patch=8, width=128, layers=2, heads=2,
             mlp_dim=512, text_width=64, text_layers=2, text_heads=4,
             text_mlp_dim=256, max_len=16, vocab_size=128,
             embedding_dim=64)
TINY_CLIP = {   # the program's CLIP at SIZES (K5's and K6's gates open)
    "projection_dim": 64,
    "max_logit_scale": 100.0,
    "text_config": dict(hidden_size=64, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=16, vocab_size=128,
                        eos_token_id=2),
    "vision_config": dict(hidden_size=128, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=tiny.PX, patch_size=8)}


def sized():
    c = harness.cell(CELL)
    cfg = copy.deepcopy(harness.config(c["config"]))
    cfg["sizes"].update(SIZES)
    cfg["experiment"]["model"].update(vocab_size=SIZES["vocab_size"],
                                      embedding_dim=SIZES["embedding_dim"])
    tr = dict(harness.traffic(c["traffic"]))
    tr.update(batch=tiny.BATCH, frame_px=tiny.PX, pool_batches=3,
              trace_steps=2, caption_tokens=[3, 13])
    return cfg, tr


def run_tiny(monkeypatch, trace=False, **overrides):
    from multimodal_baby_tpu_torch.models import clip
    monkeypatch.setitem(clip.CLIP_CONFIGS, "clip_vit_l14", TINY_CLIP)
    torch.set_num_threads(2)
    tiny.patch_augment(monkeypatch)
    cfg, tr = sized()
    return run.run_cell(CELL, tiny.SEED, 0.5, trace, "cpu", 0.0,
                        {"config": cfg, "traffic": tr, **overrides})


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys_and_metrics(trace, monkeypatch):
    res = run_tiny(monkeypatch, trace)
    assert list(res)[-1] == "checks" and res["correct"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(CELL, trace)}
    got = set(res["metrics"])
    if trace:
        # no device operation on the CPU: those readers return nothing
        assert got <= want
        assert {"trunk_ms.train", "trunk_vjp_ms.train",
                "trunk_vjp_roofline.train", "vjp_calls_per_step.train",
                "backward_ms.train"} <= got
        assert res["metrics"]["vjp_calls_per_step.train"]["value"] == \
            2 * SIZES["layers"]
    else:
        assert got == want
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert set(res["checks"]) == set(harness.limits(CELL))


def _fails(readings_):
    lim = harness.limits(CELL)
    return {what: any(v > lim[k] for k, v in r.items() if k in lim)
            for what, r in readings_}


def test_the_half_batch_fails_and_the_control_reads_high(monkeypatch):
    """At the tiny size the half batch fails the card's limits; the fp8
    control, which fails them at L/14 on the card by ``feature_gap`` (PERF
    §2: precision hardly moves the other numbers there), reads above the
    sound run on the features and the loss."""
    from multimodal_baby_tpu_torch.models import clip
    monkeypatch.setitem(clip.CLIP_CONFIGS, "clip_vit_l14", TINY_CLIP)
    torch.set_num_threads(2)
    cfg, tr = sized()
    readings_ = clip_train.control_readings(cfg, tr, tiny.SEED, "cpu")
    assert _fails(readings_)["fault_half_batch"]
    sound = run_tiny(monkeypatch)["checks"]
    control = dict(readings_)["control_fp8"]
    for k in ("feature_gap", "loss_gap"):
        assert control[k] > sound[k]["value"], k


def test_a_state_left_unchanged_fails(monkeypatch):
    from multimodal_baby_tpu_torch.train.step import make_train_step

    def unchanged(model, exp):
        real = make_train_step(model, exp)

        def step(state, batch):
            saved = [p.detach().clone() for p in model.parameters()]
            out = real(state, batch)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return out
        return step

    res = run_tiny(monkeypatch, make_train_step=unchanged)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_the_configuration_is_the_programs_clip():
    """The reference reads the configuration's sizes and optimizer, the
    program its own CLIP and the experiment's optimizer name: they agree."""
    from multimodal_baby_tpu_torch.models.clip import (
        CLIP_CONFIGS, tower_configs)
    from multimodal_baby_tpu_torch.train.optimizer import parse_optimizer
    cfg = harness.config(harness.cell(CELL)["config"])
    s, opt = cfg["sizes"], cfg["optimizer"]
    text, vision, proj = tower_configs(CLIP_CONFIGS[cfg["architecture"]])
    assert (vision.image_size, vision.patch_size, vision.hidden_size,
            vision.num_hidden_layers, vision.num_attention_heads,
            vision.intermediate_size, vision.layer_norm_eps) == (
        s["image_px"], s["patch"], s["width"], s["layers"], s["heads"],
        s["mlp_dim"], s["ln_eps"])
    assert (text.hidden_size, text.num_hidden_layers,
            text.num_attention_heads, text.intermediate_size,
            text.max_position_embeddings, text.vocab_size,
            text.layer_norm_eps, proj) == (
        s["text_width"], s["text_layers"], s["text_heads"],
        s["text_mlp_dim"], s["max_len"], s["vocab_size"],
        s["ln_eps"], s["embedding_dim"])
    assert vision.gelu == text.gelu == "sigmoid"   # QuickGELU
    assert math.log(CLIP_CONFIGS[cfg["architecture"]]["max_logit_scale"]
                    ) == ref.MAX_LOG_SCALE
    for widths in (ref.WIDTHS, text_clip.WIDTHS):   # the by-name parts'
        assert {k: s[k] for k in widths} == widths
    name, o = parse_optimizer(cfg["experiment"]["train"]["optimizer"])
    assert (name, [0.9, o["beta2"]], o["eps"], o["decay"]) == (
        opt["name"], opt["betas"], opt["eps"], "matrices")
    m = cfg["experiment"]["model"]
    assert (m["vocab_size"], m["embedding_dim"]) == (s["vocab_size"],
                                                     s["embedding_dim"])
    tr = harness.traffic(harness.cell(CELL)["traffic"])
    assert tr["batch"] == cfg["batch_size"]
    assert tr["caption_tokens"][1] + 2 <= s["max_len"]


def test_the_counts_at_the_published_sizes():
    """162 GFLOP a frame through the vision tower and 13.3 GFLOP a caption
    of 77 tokens through the text tower (the paper's shapes)."""
    cfg = harness.config(harness.cell(CELL)["config"])
    s = cfg["sizes"]
    assert counters.flops(s) == pytest.approx(162.0e9, rel=0.01)
    assert counters.text_clip.flops(s) == pytest.approx(13.3e9, rel=0.01)
    step = counters.train_step_flops(cfg, 256)
    assert step == pytest.approx(3 * 256 * (162.0e9 + 13.3e9), rel=0.01)
    assert counters.trunk_vjp_flops(cfg, 256) == 2 * counters.trunk_flops(
        cfg, 256)


def test_captions():
    ids, lens = clip_train.captions(64, (5, 75), 77, 49408, 7)
    assert ids.shape == (64, 77) and ids.dtype == np.int32
    assert (ids[:, 0] == 49406).all() and (lens >= 7).all() \
        and (lens <= 77).all()
    for row, n in zip(ids, lens):
        assert row[n - 1] == 49407 and (row[1:n - 1] < 49406).all()
        assert (row[n:] == 0).all() and row.argmax() == n - 1


def test_a_whole_cpu_run_of_the_cell_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark.tests import test_harness_clip as t\n"
        "from benchmark import harness\n"
        "class MP:\n"
        "    def setattr(self, obj, name, value): setattr(obj, name, value)\n"
        "    def setitem(self, d, k, v): d[k] = v\n"
        "t.run_tiny(MP(), trace=True)\n"
        "print('FORBIDDEN', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    assert "FORBIDDEN []" in out
