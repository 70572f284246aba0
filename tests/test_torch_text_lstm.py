"""The port's LSTM, biLSTM, CBOW, captioning and attention text encoders,
and the dropouts of every encoder, against the JAX package's TextEncoder.

The JAX encoder is initialised by the JAX package (LSTM biases perturbed
so that they matter) and moved into the port through ``api/convert.py``;
the same numpy-seeded ids, lengths, image features and feature maps go
through both on the CPU in f32. Deterministic outputs, attention weights
and gradients agree to atol 1e-5 (other summation orders). In training
the dropouts draw from the generator: ``dropout_i`` drops the LSTMs'
inputs only, ``dropout_o`` every encoder's per-step outputs with one mask
per row and channel shared over time, and the flat embedding with a fresh
draw, scaled by 1 / (1 - p).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models.text import TextEncoder as JTextEncoder
from multimodal_baby_tpu_torch.api.convert import (
    load_state_dict, text_encoder_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.text import TextEncoder

B, L, E, V, D, S = 5, 12, 16, 40, 24, 3  # D: feature-map channels, S x S map
ATOL = 1e-5

CASES = {
    "lstm": dict(text_encoder="lstm"),
    "bilstm": dict(text_encoder="bilstm"),
    "lstm_spatial": dict(text_encoder="lstm", spatial=True),
    "cbow": dict(text_encoder="cbow", spatial=True),
    "cbow_crange2": dict(text_encoder="cbow", crange=2, spatial=True),
    "captioning": dict(text_encoder="lstm", captioning=True),
    "attention": dict(text_encoder="lstm", attention=True,
                      attention_gate=True),
    "attention_tanh_captioning": dict(
        text_encoder="lstm", attention=True, captioning=True,
        attention_activation="tanh"),
}


def make_cfg(spatial=False, **text):
    return jcfg.ModelConfig(
        embedding_dim=E, vocab_size=V,
        embedding_type="spatial" if spatial else "flat",
        text=jcfg.TextConfig(**text))


def port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model


def make_inputs(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, L + 1, B).astype(np.int32)
    lens[0] = L
    text = np.zeros((B, L), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(1, V, n)
    return {"x": text, "x_len": lens,
            "image_features": rng.randn(B, E).astype(np.float32),
            "image_feature_map": rng.randn(B, S, S, D).astype(np.float32)}


def conditioning(cfg, inp):
    t = cfg.text
    return {"image_features": inp["image_features"] if t.captioning
            else None,
            "image_feature_map": inp["image_feature_map"] if t.attention
            else None}


def perturb(tree, rng):
    return {k: (perturb(v, rng) if isinstance(v, dict) else
                (np.asarray(v) + (0.1 * rng.randn(*np.shape(v)) if k in (
                    "bias_ih", "bias_hh", "bias") else 0)).astype(np.float32))
            for k, v in tree.items()}


def build_pair(cfg, fused_lstm=None):
    inp = make_inputs()
    model = JTextEncoder(cfg, image_feature_map_dim=D)
    cond = {k: None if v is None else jnp.asarray(v)
            for k, v in conditioning(cfg, inp).items()}
    params = perturb(model.init(jax.random.PRNGKey(0), jnp.asarray(inp["x"]),
                                jnp.asarray(inp["x_len"]), **cond)["params"],
                     np.random.RandomState(1))
    port = TextEncoder(port_cfg(cfg), image_feature_map_dim=D, device="cpu",
                       fused_lstm=fused_lstm)
    load_state_dict(port, text_encoder_state_dict(params, prefix=""))
    return model, params, port


def torch_cond(cfg, inp):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in conditioning(cfg, inp).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_deterministic_outputs_match_jax(case):
    cfg = make_cfg(**CASES[case])
    model, params, port = build_pair(cfg)
    inp = make_inputs(2)
    cond = {k: None if v is None else jnp.asarray(v)
            for k, v in conditioning(cfg, inp).items()}
    ret, output, attns = model.apply(
        {"params": params}, jnp.asarray(inp["x"]), jnp.asarray(inp["x_len"]),
        **cond)
    with torch.no_grad():
        t_ret, t_output, t_attns = port.encode(
            torch.from_numpy(inp["x"]).long(),
            torch.from_numpy(inp["x_len"]).long(), None,
            **torch_cond(cfg, inp))
    np.testing.assert_allclose(t_output.numpy(), np.asarray(output),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(ret), atol=ATOL,
                               rtol=0)
    if attns is None:
        assert t_attns is None
    else:
        assert t_attns.shape == (B, L, S, S)
        np.testing.assert_allclose(t_attns.numpy(), np.asarray(attns),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["lstm", "bilstm", "attention"])
def test_gradients_match_jax(case):
    """Gradients of a weighted sum of (ret, output) with respect to every
    parameter, through the bridge's names and layouts."""
    cfg = make_cfg(**CASES[case])
    model, params, port = build_pair(cfg)
    inp = make_inputs(3)
    rng = np.random.RandomState(5)
    w_ret = rng.randn(B, E).astype(np.float32)
    w_out = rng.randn(B, L, E).astype(np.float32)
    cond = {k: None if v is None else jnp.asarray(v)
            for k, v in conditioning(cfg, inp).items()}

    def j_loss(p):
        ret, output, _ = model.apply({"params": p}, jnp.asarray(inp["x"]),
                                     jnp.asarray(inp["x_len"]), **cond)
        return (ret * w_ret).sum() + (output * w_out).sum()

    want = text_encoder_state_dict(
        jax.tree.map(np.asarray, jax.grad(j_loss)(params)), prefix="")
    ret, output, _ = port.encode(torch.from_numpy(inp["x"]).long(),
                                 torch.from_numpy(inp["x_len"]).long(), None,
                                 **torch_cond(cfg, inp))
    ((ret * torch.from_numpy(w_ret)).sum()
     + (output * torch.from_numpy(w_out)).sum()).backward()
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(want)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k], atol=ATOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["lstm", "attention"])
def test_ids_to_outputs_matches_jax(case):
    """One decoding step from ids and (h, c), with the attention over the
    feature map and its projection."""
    cfg = make_cfg(**CASES[case])
    model, params, port = build_pair(cfg)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, V, B).astype(np.int32)
    h, c = (rng.randn(B, E).astype(np.float32) * 0.3 for _ in range(2))
    fmap = make_inputs()["image_feature_map"] if cfg.text.attention else None
    proj = None
    if fmap is not None:
        proj = model.apply({"params": params}, jnp.asarray(fmap),
                           method=lambda m, f:
                           m.attention.project_encoder_features(f))
    out, (h1, c1), attns = model.apply(
        {"params": params}, jnp.asarray(ids), (jnp.asarray(h), jnp.asarray(c)),
        None if fmap is None else jnp.asarray(fmap), proj,
        method="ids_to_outputs")
    with torch.no_grad():
        t_fmap = None if fmap is None else torch.from_numpy(fmap)
        t_proj = (None if fmap is None else
                  port.attention.project_encoder_features(t_fmap))
        t_out, (t_h1, t_c1), t_attns = port.ids_to_outputs(
            torch.from_numpy(ids).long(),
            (torch.from_numpy(h), torch.from_numpy(c)), t_fmap, t_proj)
    for g, w in ((t_out, out), (t_h1, h1), (t_c1, c1), (t_attns, attns)):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)


def test_init_hidden_connector_order():
    """The connector's [B, 2 d H] output is read as (B, 2, d, H): h0 the
    first half, c0 the second; a spatial map is averaged first."""
    cfg = make_cfg(**CASES["captioning"])
    model, params, port = build_pair(cfg)
    feats = make_inputs()["image_features"]
    fmap = np.random.RandomState(7).randn(B, S, S, E).astype(np.float32)
    for x in (feats, fmap):
        h0, c0 = model.apply({"params": params}, B, jnp.asarray(x),
                             method="init_hidden")
        with torch.no_grad():
            t_h0, t_c0 = port.init_hidden(B, torch.from_numpy(x))
        assert t_h0.shape == (1, B, E)
        np.testing.assert_allclose(t_h0.numpy(), np.asarray(h0), atol=ATOL)
        np.testing.assert_allclose(t_c0.numpy(), np.asarray(c0), atol=ATOL)


def test_lstm_dropout_i_draws_from_the_generator():
    cfg = make_cfg(text_encoder="lstm", dropout_i=0.5)
    *_, port = build_pair(cfg)
    inp = make_inputs(8)
    x, n = (torch.from_numpy(inp[k]).long() for k in ("x", "x_len"))

    def run(generator):
        with torch.no_grad():
            return port(x, n, generator)[0]

    a = run(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, run(torch.Generator().manual_seed(3)),
                               atol=0, rtol=0)
    assert not torch.equal(a, run(torch.Generator().manual_seed(4)))
    assert not torch.allclose(a, run(None), atol=1e-3)


@pytest.mark.parametrize("arch", ["embedding", "transformer"])
def test_dropout_i_ignored_outside_the_lstm(arch):
    """The recipes' dropout_i = 0.5 (configs/_base.py) builds every
    encoder; in eval the outputs match the JAX package's, and in training
    the embedding and transformer encoders draw the same values with
    dropout_i 0.5 as with 0."""
    cfg = make_cfg(text_encoder=arch, dropout_i=0.5)
    model, params, port = build_pair(cfg)
    inp = make_inputs(9)
    ret, output, _ = model.apply({"params": params}, jnp.asarray(inp["x"]),
                                 jnp.asarray(inp["x_len"]))
    x, n = (torch.from_numpy(inp[k]).long() for k in ("x", "x_len"))
    with torch.no_grad():
        t_ret, t_output = port(x, n)
    np.testing.assert_allclose(t_output.numpy(), np.asarray(output),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(ret), atol=ATOL,
                               rtol=0)
    no_drop = TextEncoder(port_cfg(dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dropout_i=0.0))),
        image_feature_map_dim=D, device="cpu")
    no_drop.load_state_dict(port.state_dict())
    with torch.no_grad():
        for a, b in zip(port(x, n, torch.Generator().manual_seed(2)),
                        no_drop(x, n, torch.Generator().manual_seed(2))):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        if arch == "embedding":  # nothing else draws: eval's values
            torch.testing.assert_close(
                port(x, n, torch.Generator())[1], t_output, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["embedding", "lstm"])
def test_dropout_o_locked_mask_and_fresh_flat_draw(arch):
    """dropout_o: the per-step outputs keep or drop a (row, channel) for
    every step at once, kept values scaled by 1 / (1 - p); the flat
    embedding is the eval value kept or dropped element by element."""
    p = 0.5
    cfg = make_cfg(text_encoder=arch, dropout_o=p)
    *_, port = build_pair(cfg)
    inp = make_inputs(10)
    x, n = (torch.from_numpy(inp[k]).long() for k in ("x", "x_len"))
    with torch.no_grad():
        ret0, out0 = port(x, n)
        ret, out = port(x, n, torch.Generator().manual_seed(11))
    kept = out != 0
    scale = 1.0 / (1.0 - p)
    torch.testing.assert_close(out[kept], out0[kept] * scale)
    live = out0 != 0  # the mask shows where the eval value is nonzero
    keep_mask = kept.any(dim=1, keepdim=True)  # [B, 1, E]
    assert torch.equal(kept, keep_mask & live)
    assert 0.2 < float(keep_mask.float().mean()) < 0.8
    r_kept = ret != 0
    torch.testing.assert_close(ret[r_kept], ret0[r_kept] * scale)
    assert 0.2 < float(r_kept.float().mean()) < 0.8


@pytest.mark.parametrize("bad", [
    dict(text_encoder="gru"), dict(text_encoder="embedding", captioning=True),
    dict(text_encoder="bilstm", attention=True),
    dict(text_encoder="cbow")])
def test_invalid_configurations_raise(bad):
    with pytest.raises(ValueError):
        TextEncoder(port_cfg(make_cfg(**bad)), device="cpu")
    with pytest.raises(ValueError, match="fused_lstm"):
        TextEncoder(port_cfg(make_cfg(text_encoder="lstm")), device="cpu",
                    fused_lstm="1")
