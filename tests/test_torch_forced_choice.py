"""The port's forced-choice evaluation against the JAX package's.

The same weights (JAX-initialised, moved through the port's weight bridge)
score the same trials in both packages on the CPU:

- the toy trunk (``TinyConvNet``) with the transformer text encoder (a
  learned pos-embed: the encoder the label truncation matters for) in f32,
  over 257 trials of 224 px PNG frames (no decoder resizes them; the port's
  datasets decode them, each file once, and both packages score the same
  items: tests/test_torch_eval_data.py holds the two packages' items
  equal), in image and text mode, each without the kitty swap and
  <sos>/<eos> and with both (the kitty swap's two positions: after <sos>
  in image mode, over it in text mode), at ``batch_size=64`` (a tail chunk
  of one trial). Every decision equal;
  the trials' log-probabilities (the logits less each trial's log-sum-exp)
  within 1e-4 absolute, and one chunk's logits within 1e-4 through each
  package's chunk scorer; the records' JSON equal apart from the
  probabilities, which agree within 1e-4;
- the spatial mean and max similarity against the JAX
  ``spatial_similarity`` (relative 1e-5), and forced choice on a spatial
  toy model in both sims;
- the full-width ResNeXt-50 in bf16 on an in-memory 32 px trial set of 16
  trials, the port through its CPU path (the bf16 conv path) and through
  the card's plan run by its plain versions (``forward_folded``), the JAX
  package through its bf16 conv path (its eval's trunk sees B = 4): the
  log-probabilities within 0.1 absolute (bf16 activations and folded
  weights: relative error ~1e-2 on logits of magnitude up to 1/0.07) and
  so equal decisions on every trial whose JAX top-two gap exceeds 0.2.
  Random weights are drawn with numpy on the JAX model's parameter shapes
  (``jax.eval_shape``; an eager flax init of the trunk takes ~25 s).
"""

import functools
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.data.augment import normalize_image as j_normalize
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu.evaluation import forced_choice as jfc
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models.multimodal import (
    spatial_similarity as j_spatial_similarity)
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data import datasets as tdatasets
from multimodal_baby_tpu_torch.data.datasets import (
    EvalTrialDataset, TextEvalTrialDataset)
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.evaluation import forced_choice as tfc
from multimodal_baby_tpu_torch.models.multimodal import (
    CVCL, spatial_similarity)

CATS = ["ball", "cat", "kitty", "dog", "car", "book", "apple", "shoe"]
WORDS = ["<pad>", "<unk>", "<sos>", "<eos>"] + CATS
N_TRIALS = 257
E = 32
LOGIT_ATOL = 1e-4


def make_frames(root, size=224, per_cat=3, seed=0):
    """Category-structured frames: a coarse random texture per category,
    shifted and noised per frame, saved as PNG. Returns {cat: [paths]}."""
    rng = np.random.RandomState(seed)
    paths = {}
    for ci, cat in enumerate(CATS):
        base = np.random.RandomState(100 + ci).randint(
            0, 256, (size // 8, size // 8, 3), np.uint8)
        base = np.asarray(Image.fromarray(base).resize((size, size),
                                                       Image.NEAREST))
        for v in range(per_cat):
            img = np.roll(base, 5 * v, axis=1).astype(np.int16)
            img = np.clip(img + rng.randint(-30, 31, img.shape), 0, 255)
            p = root / f"{cat}_{v}.png"
            Image.fromarray(img.astype(np.uint8)).save(p)
            paths.setdefault(cat, []).append(str(p))
    return paths


def make_trials(paths, n, seed=1):
    rng = np.random.RandomState(seed)
    trials = []
    for t in range(n):
        target = CATS[t % len(CATS)]
        foils = list(rng.choice([c for c in CATS if c != target], 3,
                                replace=False))
        trials.append({
            "trial_num": t, "target_category": target,
            "target_img_filename": paths[target][rng.randint(3)],
            "foil_categories": foils,
            "foil_img_filenames": [paths[c][rng.randint(3)] for c in foils],
        })
    return trials


def toy_cfg(embedding_type="flat", sim="max"):
    return jcfg.ModelConfig(
        embedding_dim=E, vocab_size=len(WORDS), embedding_type=embedding_type,
        sim=sim, normalize_features=True, fix_temperature=True,
        vision=jcfg.VisionConfig(cnn_model="toy"),
        text=jcfg.TextConfig(text_encoder="transformer",
                             pos_embed_type="learned"))


def port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model


def perturb_text(tree, rng):
    """Learned pos-embed, LayerNorms and biases that matter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_text(v, rng)
        elif k == "scale":
            out[k] = (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k in ("bias", "in_proj_bias", "pos_embed"):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def build_toy_pair(cfg):
    model = JCVCL(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 5), jnp.int32), jnp.ones((1,), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    params["text_encoder"] = perturb_text(params["text_encoder"],
                                          np.random.RandomState(2))
    port = CVCL(port_cfg(cfg), device="cpu")
    load_state_dict(port, cvcl_state_dict(params, {}))
    return model, {"params": params}, port


@functools.cache
def spatial_pair(sim):
    return build_toy_pair(toy_cfg("spatial", sim))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    trials = make_trials(make_frames(root), N_TRIALS)
    word2idx = {w: i for i, w in enumerate(WORDS)}
    return (trials, JVocab(word2idx), Vocab(dict(word2idx)),
            build_toy_pair(toy_cfg()))


@pytest.fixture(scope="module")
def items(setup):
    """(mode, sos) -> the port dataset's items, each file decoded once."""
    trials, _, vocab, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdatasets, "load_image_uint8",
                   functools.cache(tdatasets.load_image_uint8))
        return {(mode, sos): Items(cls(trials, vocab, sos))
                for mode, cls in (("image", EvalTrialDataset),
                                  ("text", TextEvalTrialDataset))
                for sos in (False, True)}


class Items:
    """A dataset's items, made once, with its ``data``."""

    def __init__(self, dataset):
        self.data = dataset.data
        self.items = [dataset[i] for i in range(len(dataset))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def run_both(setup, ds, mode, kitty, tmp_path):
    _, jvocab, vocab, (jmodel, variables, port) = setup
    j_acc, j_rec = jfc.run_forced_choice(
        jmodel, variables, ds, mode, batch_size=64,
        use_kitty_label=kitty, vocab=jvocab)
    t_acc, t_rec = tfc.run_forced_choice(
        port, ds, mode, batch_size=64, use_kitty_label=kitty, vocab=vocab)
    extra = {"checkpoint": "toy", "seed": 0, "stage": "dev"}
    jfc.save_predictions(j_rec, tmp_path / "j.json", extra)
    tfc.save_predictions(t_rec, tmp_path / "t.json", extra)
    return (j_acc, json.load(open(tmp_path / "j.json"))["data"],
            t_acc, json.load(open(tmp_path / "t.json"))["data"])


@pytest.mark.parametrize("kitty_and_sos", [False, True])
@pytest.mark.parametrize("mode", ["image", "text"])
def test_forced_choice_matches_jax_on_the_toy_trunk(setup, items, mode,
                                                    kitty_and_sos, tmp_path):
    kitty = kitty_and_sos
    j_acc, j_rec, t_acc, t_rec = run_both(
        setup, items[mode, kitty_and_sos], mode, kitty, tmp_path)
    assert len(t_rec) == len(j_rec) == N_TRIALS
    assert t_acc == j_acc
    assert ("cat" in t_acc) != kitty  # swapped, "cat" trials count as kitty
    for j, t in zip(j_rec, t_rec):
        assert {k: v for k, v in t.items() if k != "logits"} == \
            {k: v for k, v in j.items() if k != "logits"}
    jp = np.asarray([r["logits"] for r in j_rec])
    tp = np.asarray([r["logits"] for r in t_rec])
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.log(tp), np.log(jp), atol=LOGIT_ATOL,
                               rtol=0)
    # the decisions are not all alike: the trials test something
    assert 0 < sum(r["correct"] for r in t_rec) < N_TRIALS


@pytest.mark.parametrize("mode", ["image", "text"])
def test_chunk_logits_match_jax(setup, items, mode):
    """One chunk's logits [n, K] through each package's chunk scorer."""
    _, _, _, (jmodel, variables, port) = setup
    chunk = [items[mode, True][i] for i in range(16)]
    images = np.stack([it[0] for it in chunk])
    labels = np.stack([it[1] for it in chunk])[..., :3]
    lens = np.asarray([it[2] for it in chunk])
    with torch.no_grad():
        got = tfc._score_chunk(port, images, labels, lens, mode).numpy()
    x = j_normalize(jnp.asarray(images))
    if mode == "image":
        want = jfc._score_trials_fn(jmodel, variables, mode)(
            x, jnp.asarray(labels)[:, None], jnp.asarray(lens)[:, None])
    else:
        want = jfc._score_trials_fn(jmodel, variables, mode)(
            x[:, None], jnp.asarray(labels), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("sim", ["mean", "max"])
def test_spatial_similarity_matches_jax(sim):
    rng = np.random.RandomState(3)
    img = rng.randn(5, 3, 4, 16).astype(np.float32)
    txt = rng.randn(6, 7, 16).astype(np.float32)
    lens = rng.randint(1, 8, 6).astype(np.int32)
    want = np.asarray(j_spatial_similarity(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(lens), sim))
    got = spatial_similarity(torch.from_numpy(img), torch.from_numpy(txt),
                             torch.from_numpy(lens), sim).numpy()
    assert got.shape == (5, 6)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["image", "text"])
@pytest.mark.parametrize("sim", ["mean", "max"])
def test_spatial_forced_choice_matches_jax(items, sim, mode):
    """A spatial toy model (7 x 7 maps at 224 px) in both sims: 70 trials,
    a full chunk of 64 and a tail of 6."""
    jmodel, variables, port = spatial_pair(sim)
    ds = Items.__new__(Items)
    ds.data, ds.items = (items[mode, True].data[:70],
                         items[mode, True].items[:70])
    _, j_rec = jfc.run_forced_choice(jmodel, variables, ds, mode,
                                     batch_size=64)
    _, t_rec = tfc.run_forced_choice(port, ds, mode, batch_size=64)
    assert [r["pred"] for r in t_rec] == [r["pred"] for r in j_rec]
    np.testing.assert_allclose(
        np.log([r["logits"] for r in t_rec]),
        np.log([r["logits"] for r in j_rec]), atol=LOGIT_ATOL, rtol=0)


# ----------------------------------------------- full-width ResNeXt-50, bf16

RESNEXT_TRIALS = 16
BF16_LOGIT_ATOL = 0.1
BF16_MARGIN = 2 * BF16_LOGIT_ATOL


def random_tree(tree, rng):
    """numpy values on a tree of shapes: convolutions N(0, 2 / fan_in),
    Dense kernels U(-1/sqrt(in), 1/sqrt(in)), BN and LayerNorm scales
    1 + 0.1 N, biases and running means 0.1 N, running variances
    U(0.5, 2), embeddings N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_tree(v, rng)
            continue
        shape = v.shape
        if k == "kernel" and len(shape) == 4:
            x = rng.randn(*shape) * np.sqrt(2 / np.prod(shape[:3]))
        elif k == "kernel":
            x = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        elif k == "scale":
            x = 1 + 0.1 * rng.randn(*shape)
        elif k == "var":
            x = rng.uniform(.5, 2., shape)
        elif k in ("bias", "mean"):
            x = 0.1 * rng.randn(*shape)
        else:
            x = rng.randn(*shape)
        out[k] = x.astype(np.float32)
    return out


class InMemoryTrials:
    """Image-mode trials on in-memory 32 px frames, items as
    ``EvalTrialDataset`` makes them."""

    def __init__(self, n, seed=4):
        rng = np.random.RandomState(seed)
        frames = {c: rng.randint(0, 256, (3, 32, 32, 3), np.uint8)
                  for c in CATS}
        self.data, self.items = [], []
        for t in range(n):
            target = CATS[t % len(CATS)]
            foils = [c for c in CATS if c != target][t % 4:t % 4 + 3]
            self.data.append({"target_category": target,
                              "foil_categories": foils})
            imgs = np.stack([frames[c][rng.randint(3)]
                             for c in [target] + foils])
            ids = np.zeros((25,), np.int32)
            ids[:3] = [2, WORDS.index(target), 3]
            self.items.append((imgs, ids, 3, target))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_resnext_bf16_forced_choice_matches_jax():
    cfg = jcfg.ModelConfig(
        embedding_dim=E, vocab_size=len(WORDS), embedding_type="flat",
        normalize_features=True, fix_temperature=True,
        vision=jcfg.VisionConfig(frozen_bn="running"),
        text=jcfg.TextConfig(text_encoder="embedding"))
    jmodel = JCVCL(cfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 3), jnp.int32),
                            jnp.ones((1,), jnp.int32))
    rng = np.random.RandomState(1)
    params = random_tree(shapes["params"], rng)
    stats = random_tree(shapes["batch_stats"], rng)
    port = CVCL(port_cfg(cfg), dtype=torch.bfloat16, device="cpu")
    load_state_dict(port, cvcl_state_dict(params, stats))
    ds = InMemoryTrials(RESNEXT_TRIALS)

    _, j_rec = jfc.run_forced_choice(
        jmodel, {"params": params, "batch_stats": stats}, ds, "image",
        batch_size=8)
    jl = np.log([r["logits"] for r in j_rec])
    top2 = np.sort(jl, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > BF16_MARGIN
    assert clear.sum() >= 4
    trunk = port.vision_encoder.model
    for path in ("conv", "folded"):
        if path == "folded":  # the card's plan, through its plain versions
            trunk.forward = lambda x, train=False: trunk.forward_folded(
                x.to(trunk.dtype))
        _, t_rec = tfc.run_forced_choice(port, ds, "image", batch_size=16)
        tl = np.log([r["logits"] for r in t_rec])
        print(f"{path}: max |log-prob| difference "
              f"{np.abs(tl - jl).max():.4f}, {int(clear.sum())} clear trials")
        np.testing.assert_allclose(tl, jl, atol=BF16_LOGIT_ATOL, rtol=0)
        preds = np.asarray([r["pred"] for r in t_rec])
        jpreds = np.asarray([r["pred"] for r in j_rec])
        assert (preds[clear] == jpreds[clear]).all()
