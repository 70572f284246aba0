"""The port's language-model half against the JAX package: the LM losses,
the tied and untied heads, the joint contrastive + LM train step and the
LM-only ones (LSTM, CBOW on spatial embeddings, and the image-conditioned
LSTM), and beam search.

The JAX CVCL (ResNeXt-50 at full width on 32x32 frames, a 32-d head, the
LSTM text encoder) is initialised by the JAX package, its BN statistics
perturbed and its last BN shift raised by 1 (so that no pooled feature
sits at the ReLU's zero, where the two packages' f32 trunks could pass a
channel or not), and moved into the port through ``api/convert.py``; the
same numpy-seeded batches go through both on the CPU in f32 with the
dropout rates at 0. Tolerances: losses and heads rtol 1e-5 (other
summation orders); in the train steps, the losses at rtol 1e-5, every
gradient of every step at rtol 1e-5 of its tensor's largest value, and
the updated parameters at rtol 1e-5 of each tensor's largest value, over
the elements whose gradient was 0 or at least 1e-7 in every step. Below
that, AdamW's first step g / (|g| + 1e-8) turns the f32 trunks'
difference in a gradient (up to 1e-8 here) into a difference of up to the
whole learning rate; those elements are held by the gradient check alone.
Beam search: sequences identical and scores rtol 1e-5, on logits without
ties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models import losses as jlosses
from multimodal_baby_tpu.models.beam_search import beam_search as j_beam
from multimodal_baby_tpu.train import build_optimizer as j_build_optimizer
from multimodal_baby_tpu.train.step import (
    TrainState as JTrainState, make_loss_fn as j_make_loss_fn,
    make_train_step as j_make_train_step)
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models import losses
from multimodal_baby_tpu_torch.models.beam_search import beam_search
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_train_step)

B, E, V, L, IMG = 6, 32, 64, 10, 32
RTOL = 1e-5
ADAM_SENSITIVE = 1e-7  # 10x AdamW's eps

# name -> (text config, train lambdas)
RECIPES = {
    # configs/saycam_joint.py
    "joint": (dict(text_encoder="lstm"),
              dict(lambda_mm=0.5, lambda_lm=0.5)),
    # configs/saycam_lm.py
    "lm_only": (dict(text_encoder="lstm"), dict(lambda_mm=0.0,
                                                lambda_lm=1.0)),
    # configs/saycam_cbow.py: the CBOW encoder needs spatial embeddings;
    # the LM reads its outputs unshifted
    "cbow": (dict(text_encoder="cbow", crange=1),
             dict(lambda_mm=0.0, lambda_lm=1.0)),
    # the captioning LM with attention over the feature map and its gate
    "captioning_attention": (
        dict(text_encoder="lstm", captioning=True, attention=True,
             attention_gate=True),
        dict(lambda_mm=0.0, lambda_lm=1.0, lambda_ar=0.1)),
}


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def make_cfg(recipe, tie=True, bias=True):
    text, lambdas = RECIPES[recipe]
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=E, vocab_size=V,
            embedding_type=("spatial" if text["text_encoder"] == "cbow"
                            else "flat"),
            normalize_features=True, fix_temperature=True, temperature=0.07,
            tie=tie, bias=bias,
            vision=jcfg.VisionConfig(frozen_bn="running"),
            text=jcfg.TextConfig(**text)),
        train=jcfg.TrainConfig(lr=1e-4, weight_decay=0.1,  # the recipes'
                               optimize_unused=True, **lambdas))


def make_batch(seed=0):
    """SOS, words, EOS, then PAD, as the tokenizer gives them."""
    rng = np.random.RandomState(seed)
    text = np.zeros((B, L), np.int32)
    lens = rng.randint(3, L + 1, B).astype(np.int32)
    for i, n in enumerate(lens):
        text[i, 0], text[i, n - 1] = 2, 3
        text[i, 1:n - 1] = rng.randint(4, V, n - 2)
    return {"image": rng.randn(B, IMG, IMG, 3).astype(np.float32),
            "text": text, "text_len": lens}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def perturb(tree, rng):
    return {k: (perturb(v, rng) if isinstance(v, dict) else
                (rng.uniform(.5, 2., v.shape) if k == "var"
                 else .1 * rng.randn(*v.shape)).astype(np.float32))
            for k, v in tree.items()}


_PAIRS = {}


def build_pair(recipe, tie=True, bias=True):
    """(JAX model, params, batch_stats, port model) on the same weights."""
    key = (recipe, tie, bias)
    if key not in _PAIRS:
        cfg = make_cfg(recipe, tie, bias)
        model = JCVCL(cfg.model)
        jb = jax_batch(make_batch())
        # an attention encoder cannot run the contrastive __call__: build
        # through the LM half, which encodes the image for it
        variables = model.init(jax.random.PRNGKey(0), jb["image"],
                               jb["text"], jb["text_len"],
                               method="joint_forward",
                               use_mm=not cfg.model.text.attention,
                               use_lm=True)
        params = jax.tree.map(np.asarray, variables["params"])
        rng = np.random.RandomState(1)
        if "lm_bias" in params:  # a bias that matters
            params["lm_bias"] = (0.1 * rng.randn(V)).astype(np.float32)
        bn3 = params["vision_encoder"]["backbone"]["layer4_2"]["bn3"]
        bn3["bias"] = bn3["bias"] + np.float32(1.0)
        stats = perturb(jax.device_get(variables["batch_stats"]), rng)
        _PAIRS[key] = (cfg, model, params, stats)
    cfg, model, params, stats = _PAIRS[key]
    port = CVCL(tcfg.ExperimentConfig.from_json(cfg.to_json()).model,
                device="cpu")
    load_state_dict(port, cvcl_state_dict(params, stats))
    return cfg, model, params, stats, port


def test_lm_losses_match_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(B, L - 1, V) * 2).astype(np.float32)
    labels = make_batch(3)["text"][:, 1:]
    weight = rng.uniform(0.5, 1.5, V).astype(np.float32)
    attns = rng.uniform(0, 0.3, (B, L, 3, 3)).astype(np.float32)
    for w in (None, weight):
        j_ce, j_mask = jlosses.lm_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if w is None else jnp.asarray(w))
        ce, mask = losses.lm_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels).long(),
            None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        np.testing.assert_allclose(ce.numpy(), np.asarray(j_ce), rtol=RTOL,
                                   atol=1e-6)
        assert float(ce[~mask].abs().max()) == 0.0
    want = jlosses.lm_loss_breakdown(j_ce, jnp.asarray(labels))
    got = losses.lm_loss_breakdown(ce, torch.from_numpy(labels).long())
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(losses.attn_reg_loss(torch.from_numpy(attns))),
        float(jlosses.attn_reg_loss(jnp.asarray(attns))), rtol=RTOL)


@pytest.mark.parametrize("tie,bias", [(True, True), (False, False)])
def test_lm_head_matches_jax(tie, bias):
    """Tied: the head reads the raw embedding table, and its gradient
    reaches every row, PAD's included."""
    cfg, model, params, stats, port = build_pair("joint", tie, bias)
    rng = np.random.RandomState(4)
    outputs = rng.randn(B, L, E).astype(np.float32)
    w = rng.randn(B, L, V).astype(np.float32)

    def j_loss(p):
        logits = model.apply({"params": p, "batch_stats": stats},
                             jnp.asarray(outputs), method="lm_output_layer")
        return (logits * w).sum(), logits

    (_, want), grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    got = port.lm_output_layer(torch.from_numpy(outputs))
    (got * torch.from_numpy(w)).sum().backward()
    assert rel_err(got.detach(), want) < RTOL
    want_g = cvcl_state_dict(jax.tree.map(np.asarray, grads), stats)
    named = dict(port.named_parameters())
    head = ["text_encoder.embedding.weight" if tie
            else "language_model.output_layer.weight"]
    head += ["language_model.output_layer.bias"] if bias else []
    for k in head:
        assert rel_err(named[k].grad, want_g[k]) < RTOL, k
    if tie:
        assert float(named[head[0]].grad[0].abs().max()) > 0  # the PAD row


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_steps_match_jax(recipe):
    """Two AdamW steps from the same weights on two batches: the same
    losses and LM metrics, the same gradients in each step, and the same
    parameters after, every trainable one (the frozen trunk does not move;
    the terms a recipe leaves out still decay their parameters, as
    optax)."""
    cfg, model, params, stats, port = build_pair(recipe)
    batches = [make_batch(5), make_batch(6)]
    optimizer = j_build_optimizer(cfg, params)
    state = JTrainState(params, stats, optimizer.init(params),
                        jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    j_step = j_make_train_step(model, cfg, optimizer, donate=False)
    j_grad = jax.grad(j_make_loss_fn(model, cfg), has_aux=True)
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    t_state = init_train_state(port, t_cfg)
    t_step = make_train_step(port, t_cfg)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    named = dict(port.named_parameters())
    sensitive = {k: torch.zeros_like(p, dtype=torch.bool)
                 for k, p in named.items()}
    for batch in batches:
        grads, _ = j_grad(state.params, state.batch_stats, jax_batch(batch),
                          jax.random.PRNGKey(0), True)
        want_g = cvcl_state_dict(jax.tree.map(np.asarray, grads),
                                 state.batch_stats)
        state, want = j_step(state, jax_batch(batch))
        got = t_step(t_state, torch_batch(batch))
        assert sorted(got) == sorted(want)
        for k in ("loss", "ce_loss", "ce_loss_wo_sos_eos", "n_tokens",
                  "infonce_loss", "attn_reg_loss"):
            if k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           rtol=RTOL, err_msg=k)
        for k, p in named.items():
            if not p.requires_grad:
                continue
            assert rel_err(p.grad, want_g[k]) < RTOL or (
                np.abs(want_g[k]).max() == 0
                and float(p.grad.abs().max()) == 0), k
            sensitive[k] |= (p.grad != 0) & (p.grad.abs() < ADAM_SENSITIVE)
    want_new = cvcl_state_dict(jax.tree.map(np.asarray, state.params),
                               state.batch_stats)
    moved = 0
    for name, p in port.state_dict().items():
        ok = ~sensitive[name] if name in sensitive else torch.ones_like(
            p, dtype=torch.bool)
        want = want_new[name]
        err = (p - torch.tensor(want))[ok].abs().max()
        assert float(err) <= RTOL * np.abs(want).max(), name
        moved += not torch.equal(p, before[name])
    trainable = sum(p.requires_grad for p in port.parameters())
    assert moved == trainable  # the vision head too, by decay alone


@pytest.mark.parametrize("alpha,stop_early", [(0.0, True), (0.6, True),
                                              (0.6, False)])
def test_beam_search_matches_jax(alpha, stop_early):
    """A fixed transition table plus a per-beam drift carried in the
    states (so that the states' reindexing matters)."""
    Vb, Bb, W, T = 12, 3, 3, 7
    rng = np.random.RandomState(int(alpha * 10) + stop_early)
    table = (rng.randn(Vb, Vb) * 2).astype(np.float32)
    drift = rng.randn(Vb).astype(np.float32)
    start = np.array([2, 5, 7], np.int32)
    state0 = rng.randn(Bb, 1).astype(np.float32)

    def j_fn(ids, states):
        (s,) = states
        return jnp.asarray(table)[ids] + s * jnp.asarray(drift), (s + 1.0,)

    def t_fn(ids, states):
        (s,) = states
        return torch.from_numpy(table)[ids] + s * torch.from_numpy(drift), (
            s + 1.0,)

    want = j_beam(j_fn, jnp.asarray(start), W, T, Vb, alpha,
                  states=(jnp.asarray(state0),), eos_id=3,
                  stop_early=stop_early)
    got = beam_search(t_fn, torch.from_numpy(start).long(), W, T, Vb, alpha,
                      states=(torch.from_numpy(state0),), eos_id=3,
                      stop_early=stop_early)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL)


@pytest.mark.parametrize("recipe", ["joint", "captioning_attention"])
def test_beam_search_decode_matches_jax(recipe):
    """CVCL decoding from SOS, unconditioned or conditioned on image
    features (the connector) and a feature map (the attention)."""
    cfg, model, params, stats, port = build_pair(recipe)
    rng = np.random.RandomState(8)
    conditioned = cfg.model.text.captioning
    feats = rng.randn(B, E).astype(np.float32) if conditioned else None
    fmap = (rng.randn(B, 2, 2, 2048).astype(np.float32)
            if cfg.model.text.attention else None)
    seq, scores = model.apply(
        {"params": params, "batch_stats": stats}, B, 3, 12, 0.6,
        None if feats is None else jnp.asarray(feats),
        None if fmap is None else jnp.asarray(fmap),
        method="beam_search_decode")
    t_seq, t_scores = port.beam_search_decode(
        B, 3, 12, 0.6, None if feats is None else torch.from_numpy(feats),
        None if fmap is None else torch.from_numpy(fmap))
    assert t_seq.shape == (B, 3, 13)
    np.testing.assert_array_equal(t_seq.numpy(), np.asarray(seq))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(scores),
                               rtol=RTOL)


def test_joint_forward_reuse_rules():
    """Unconditioned, the LM reads the contrastive text outputs (one text
    encoding); conditioned, it encodes the text again with the image."""
    calls = []
    for recipe in ("joint", "captioning_attention"):
        cfg, _, _, _, port = build_pair(recipe)
        real = port.text_encoder.encode

        def spy(*args, _real=real, **kw):
            calls.append(recipe)
            return _real(*args, **kw)

        port.text_encoder.encode = spy
        tb = torch_batch(make_batch(9))
        with torch.no_grad():
            out = port.joint_forward(tb["image"], tb["text"], tb["text_len"],
                                     use_mm=not cfg.model.text.attention,
                                     use_lm=True)
        assert out["lm_logits"].shape == (B, L - 1, V)  # shifted by one
        torch.testing.assert_close(out["lm_labels"], tb["text"][:, 1:])
    assert calls == ["joint", "captioning_attention"]


def test_spatial_head_matches_jax():
    """The CBOW recipe's spatial embeddings: the head maps every position
    of the feature map, and the features are normalised along channels."""
    cfg, model, params, stats, port = build_pair("cbow")
    image = make_batch(10)["image"]
    feats, fmap = model.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(image), method="encode_image")
    with torch.no_grad():
        t_feats, t_fmap = port.encode_image(torch.from_numpy(image))
    assert t_feats.shape == (B, 1, 1, E) == feats.shape
    assert rel_err(t_fmap, fmap) < RTOL
    assert rel_err(t_feats, feats) < RTOL
    torch.testing.assert_close(t_feats.norm(dim=-1),
                               torch.ones(B, 1, 1), rtol=1e-5, atol=0)
