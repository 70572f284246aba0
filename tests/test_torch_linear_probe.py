"""The port's linear probe against the JAX package's.

``half_split``, ``probe_accuracy`` and ``probe_forced_choice`` (copies)
give the same results; the port's Adam steps (``torch.optim.Adam``) equal
``optax.adam`` on the same 20 fixed minibatches from the same init within
1e-6; both packages' ``train_linear_probe`` fit a separable synthetic set
(train accuracy 1.0); and the feature extractors equal the JAX package's
on a toy-trunk CVCL (f32, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.evaluation import linear_probe as jlp
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.evaluation import linear_probe as tlp
from multimodal_baby_tpu_torch.models.multimodal import CVCL


def test_half_split_matches_jax():
    labels = np.random.RandomState(0).randint(0, 5, 37)
    for split in ("first", "last"):
        for got, want in zip(tlp.half_split(labels, split),
                             jlp.half_split(labels, split)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tlp.half_split(labels, "middle")


def test_probe_scores_match_jax():
    rng = np.random.RandomState(1)
    params = {"kernel": rng.randn(8, 5).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    feats = rng.randn(30, 8).astype(np.float32)
    labels = rng.randint(0, 5, 30)
    assert tlp.probe_accuracy(params, feats, labels) == \
        jlp.probe_accuracy(params, feats, labels)
    trials = rng.randn(12, 4, 8).astype(np.float32)
    targets = rng.randint(0, 5, 12)
    acc, preds = tlp.probe_forced_choice(params, trials, targets)
    j_acc, j_preds = jlp.probe_forced_choice(params, trials, targets)
    assert acc == j_acc
    np.testing.assert_array_equal(preds, j_preds)


def test_adam_steps_match_optax():
    rng = np.random.RandomState(2)
    n, d, c, lr = 64, 16, 5, 5e-4
    feats = rng.randn(n, d).astype(np.float32)
    labels = rng.randint(0, c, n)
    k = 1 / np.sqrt(d)
    init = {"kernel": rng.uniform(-k, k, (d, c)).astype(np.float32),
            "bias": np.zeros(c, np.float32)}
    batches = [rng.randint(0, n, 16) for _ in range(20)]

    def loss_fn(p, x, y):
        logp = jax.nn.log_softmax(x @ p["kernel"] + p["bias"])
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    opt = optax.adam(lr)

    @jax.jit
    def step(p, state, x, y):
        updates, state = opt.update(jax.grad(loss_fn)(p, x, y), state, p)
        return optax.apply_updates(p, updates), state

    p = jax.tree.map(jnp.asarray, init)
    state = opt.init(p)
    for idx in batches:
        p, state = step(p, state, jnp.asarray(feats[idx]),
                        jnp.asarray(labels[idx]))

    got = tlp.fit_probe({k: torch.from_numpy(v) for k, v in init.items()},
                        torch.from_numpy(feats), torch.from_numpy(labels),
                        [torch.from_numpy(i) for i in batches], lr)
    for name in ("kernel", "bias"):
        moved = np.abs(np.asarray(p[name]) - init[name]).max()
        assert moved > 1e-3  # the 20 steps moved the parameters
        np.testing.assert_allclose(got[name].numpy(), np.asarray(p[name]),
                                   atol=1e-6, rtol=0)


def test_train_linear_probe_fits_a_separable_set():
    rng = np.random.RandomState(3)
    centers = rng.randn(4, 32) * 4
    labels = np.repeat(np.arange(4), 40)
    feats = (centers[labels] + rng.randn(160, 32)).astype(np.float32)
    # 100 epochs of 5 steps (batch 32)
    params, metrics = tlp.train_linear_probe(feats, labels, 4,
                                             batch_size=32, device="cpu")
    _, j_metrics = jlp.train_linear_probe(feats, labels, 4, batch_size=32)
    assert params["kernel"].shape == (32, 4) and params["bias"].shape == (4,)
    assert metrics["train_acc"] == j_metrics["train_acc"] == 1.0
    assert metrics["n_train"] == j_metrics["n_train"] == 160
    assert tlp.probe_accuracy(params, feats, labels) == 1.0
    _, sub = tlp.train_linear_probe(feats, labels, 4, epochs=1,
                                    subset_fraction=0.1, device="cpu")
    assert sub["n_train"] == jlp.train_linear_probe(
        feats, labels, 4, epochs=1, subset_fraction=0.1)[1]["n_train"] == 16


def test_feature_extractors_match_jax():
    cfg = jcfg.ModelConfig(
        embedding_dim=16, vocab_size=12, normalize_features=True,
        vision=jcfg.VisionConfig(cnn_model="toy"),
        text=jcfg.TextConfig(text_encoder="embedding"))
    model = JCVCL(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    port = CVCL(tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model, device="cpu")
    load_state_dict(port, cvcl_state_dict(params, {}))
    images = np.random.RandomState(4).randint(0, 256, (5, 64, 64, 3),
                                              np.uint8)
    for t_fn, j_fn in ((tlp.extract_backbone_features,
                        jlp.extract_backbone_features),
                       (tlp.extract_features, jlp.extract_features)):
        got = t_fn(port, images, batch_size=2)
        want = j_fn(model, {"params": params}, images, batch_size=2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
