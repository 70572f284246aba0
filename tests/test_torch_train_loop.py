"""The port's training-loop pieces against the JAX package's: the plateau
LR schedule, the epoch aggregation of step metrics, and the optimizers
(AdamW, Adam, SGD under the frozen-trunk mask) with the LR set between
steps. Inputs are drawn from numpy seeds; tolerances are stated where
they are used.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.train import metrics as jmetrics
from multimodal_baby_tpu.train import optimizer as jopt
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train import metrics as tmetrics
from multimodal_baby_tpu_torch.train import optimizer as topt

# updated parameters: |got - want| <= OPT_RTOL * the tensor's largest value
# + UPDATE_RTOL * the largest update of the two steps. The second term:
# optax computes Adam's bias corrections in f32 (1 - 0.999 ->
# 0.00099998713), torch in float64, which moves every Adam update by
# 6.4e-6 of itself (it alone matters for the zero-initialised LM bias)
OPT_RTOL = 1e-6
UPDATE_RTOL = 1e-5


def test_plateau_matches_jax():
    """The same LR after every epoch, and the same state, over a val-loss
    sequence with improvements, ties (a tie is no improvement) and a
    floor at min_lr."""
    losses = [3.0, 2.5, 2.5, 2.5, 2.4, 2.6, 2.6, 2.6, 2.6, 1.0, 1.0,
              1.0, 1.0, 1.0, 1.0, 1.0, 0.5]
    for factor, patience, min_lr in ((0.5, 0, 0.0), (0.1, 1, 1e-4),
                                     (0.5, 2, 3e-4)):
        j = jopt.ReduceLROnPlateau(factor, patience, min_lr)
        t = topt.ReduceLROnPlateau(factor, patience, min_lr)
        lr_j = lr_t = 1e-3
        seq = []
        for v in losses:
            lr_j, lr_t = j.step(v, lr_j), t.step(v, lr_t)
            assert lr_t == lr_j and t.state_dict() == j.state_dict()
            seq.append(lr_t)
        assert min(seq) < 1e-3 and min(seq) >= min_lr
        if min_lr:
            assert min(seq) == min_lr
        # a restored tracker goes on as the original
        r = topt.ReduceLROnPlateau(factor, patience, min_lr)
        r.load_state_dict(t.state_dict())
        assert r.step(5.0, 1e-3) == t.step(5.0, 1e-3)


def random_outputs(rng, n, lm):
    out = []
    for _ in range(n):
        o = {"batch_size": float(rng.randint(1, 17)),
             "temperature": float(rng.uniform(0.05, 0.1))}
        for k in tmetrics.PER_EXAMPLE_METRICS:
            o[k] = float(rng.uniform(0, 3))
        if lm:
            for k, nk in tmetrics.PER_TOKEN_METRICS.items():
                o[k] = float(rng.uniform(0, 5))
                o[nk] = float(rng.randint(1, 200))
        out.append(o)
    return out


@pytest.mark.parametrize("lm", [False, True])
def test_aggregate_epoch_matches_jax(lm):
    """Per-example weighting by batch size, per-token weighting by token
    counts, perplexity and the last temperature: equal to the JAX
    package's to the last bit (the same float64 sums)."""
    rng = np.random.RandomState(3 + lm)
    outputs = random_outputs(rng, 7, lm)
    got = tmetrics.aggregate_epoch(outputs)
    assert got == jmetrics.aggregate_epoch(outputs)
    assert ("perplexity" in got) == lm
    w = np.asarray([o["batch_size"] for o in outputs])
    want = (w * [o["loss"] for o in outputs]).sum() / w.sum()
    assert math.isclose(got["loss"], want, rel_tol=1e-12)
    assert tmetrics.aggregate_epoch([]) == {}


def test_to_host_and_logger(tmp_path):
    m = {"loss": torch.tensor(1.5), "n": 3, "raw": ["a"], "s": "x"}
    assert tmetrics.to_host(m) == {"loss": 1.5, "n": 3.0}
    log = tmetrics.MetricsLogger(tmp_path, use_wandb=False)
    log.log({"loss": 1.5}, 7, prefix="train_")
    log.close()
    import json
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["train_loss"] == 1.5 and rec["step"] == 7


def make_cfg(name):
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=16, vocab_size=32, normalize_features=True,
            vision=jcfg.VisionConfig(cnn_model="toy"),
            text=jcfg.TextConfig(text_encoder="embedding")),
        train=jcfg.TrainConfig(optimizer=name, lr=1e-3, weight_decay=0.1))


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_optimizer_steps_match_optax(name):
    """Two steps on the same random gradients, the LR set to a third
    between them with set_learning_rate: every parameter equal to the
    optax build's (masked, LR injected) within the tolerance above, the
    frozen toy trunk unchanged, and get_learning_rate equal at f32 (optax
    keeps the LR as an f32 array)."""
    cfg = make_cfg(name)
    rng = np.random.RandomState(0)
    model = JCVCL(cfg.model)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)),
        jnp.ones((2, 6), jnp.int32), jnp.full((2,), 6, jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    port = CVCL(tcfg.ExperimentConfig.from_json(cfg.to_json()).model,
                device="cpu")
    load_state_dict(port, cvcl_state_dict(params, {}))
    before = {k: v.clone() for k, v in port.state_dict().items()}

    opt_j = jopt.build_optimizer(cfg, params)
    state_j = opt_j.init(params)
    opt_t = topt.build_optimizer(
        tcfg.ExperimentConfig.from_json(cfg.to_json()), port)
    assert np.float32(topt.get_learning_rate(opt_t)) == np.float32(
        jopt.get_learning_rate(state_j))
    # the frozen trunk's gradients are zero (stop_gradient in the JAX
    # model; optax.masked passes a masked leaf's update through as it is)
    mask = jopt.frozen_mask(params, False)
    for step in range(2):
        grads = jax.tree.map(
            lambda p, m: np.asarray(rng.randn(*p.shape) * m, np.float32),
            params, mask)
        updates, state_j = opt_j.update(grads, state_j, params)
        params = jax.tree.map(np.asarray,
                              optax.apply_updates(params, updates))
        g = cvcl_state_dict(grads, {})
        for k, p in port.named_parameters():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        opt_t.step()
        if step == 0:
            lr = jopt.get_learning_rate(state_j) / 3
            state_j = jopt.set_learning_rate(state_j, lr)
            topt.set_learning_rate(opt_t, lr)
            assert np.float32(topt.get_learning_rate(opt_t)) == np.float32(
                jopt.get_learning_rate(state_j))
    want = cvcl_state_dict(params, {})
    got = port.state_dict()
    trainable = {k for k, p in port.named_parameters() if p.requires_grad}
    assert trainable == {"vision_encoder.model.fc.weight",
                         "vision_encoder.model.fc.bias",
                         "text_encoder.embedding.weight",
                         "model.logit_neg_log_temperature",
                         "language_model.output_layer.bias"}
    for k in want:
        if k in trainable:
            step = np.abs(want[k] - before[k].numpy()).max()
            assert step > 0, k
            err = np.abs(got[k].numpy() - want[k]).max()
            assert err <= (OPT_RTOL * np.abs(want[k]).max()
                           + UPDATE_RTOL * step), (k, err, step)
        else:
            assert torch.equal(got[k], before[k]), k
            np.testing.assert_array_equal(got[k], want[k])
    assert len(opt_t.state) == len(trainable) or name == "SGD"


def test_unknown_optimizer_refused():
    cfg = tcfg.ExperimentConfig.from_json(make_cfg("RMSprop").to_json())
    port = CVCL(cfg.model, device="cpu")
    with pytest.raises(ValueError, match="RMSprop"):
        topt.build_optimizer(cfg, port)
