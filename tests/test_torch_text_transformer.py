"""The port's transformer text encoder against the JAX package's.

The JAX TextEncoder in transformer mode (one post-norm layer, 8 heads)
is initialised by the JAX package, its learned pos-embed, LayerNorms and
biases perturbed so that they matter, and moved into the port through
``api/convert.py``. Deterministic outputs agree to atol 1e-5 (f32, other
summation orders) with a learned, a sinusoidal and no pos-embed. In
training, the dropout draws from the generator: the same seed gives the
same output, which differs from eval.
"""

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

B, L, E, V = 4, 25, 64, 50


def make_cfg(pos):
    return jcfg.ModelConfig(
        embedding_dim=E, vocab_size=V,
        text=jcfg.TextConfig(text_encoder="transformer", pos_embed_type=pos))


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, L, B).astype(np.int32)
    text = np.zeros((B, L), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(1, V, n)
    return text, lens


def perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k in ("bias", "in_proj_bias", "pos_embed"):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def build_pair(pos):
    cfg = make_cfg(pos)
    text, lens = make_batch()
    model = JTextEncoder(cfg)
    params = perturb(model.init(jax.random.PRNGKey(0), jnp.asarray(text),
                                jnp.asarray(lens))["params"],
                     np.random.RandomState(1))
    port = TextEncoder(port_cfg(cfg), device="cpu")
    load_state_dict(port, text_encoder_state_dict(params, prefix=""))
    return model, params, port


def port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model


@pytest.mark.parametrize("pos", ["learned", "sinusoidal", "no_pos_embed"])
def test_deterministic_outputs_match_jax(pos):
    model, params, port = build_pair(pos)
    text, lens = make_batch(2)
    ret, output, _ = model.apply({"params": params}, jnp.asarray(text),
                                 jnp.asarray(lens), deterministic=True)
    with torch.no_grad():
        t_ret, t_output = port(torch.from_numpy(text).long(),
                               torch.from_numpy(lens).long())
    np.testing.assert_allclose(t_output.numpy(), np.asarray(output),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(ret), atol=1e-5,
                               rtol=0)


def test_dropout_reproducible_from_the_generator():
    *_, port = build_pair("learned")
    text, lens = (torch.from_numpy(a).long() for a in make_batch(3))

    def run(generator):
        with torch.no_grad():
            return port(text, lens, generator)[0]

    a = run(torch.Generator().manual_seed(5))
    b = run(torch.Generator().manual_seed(5))
    c = run(torch.Generator().manual_seed(6))
    evaluated = run(None)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    assert not torch.allclose(a, evaluated, atol=1e-3)
