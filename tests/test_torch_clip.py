"""The port's CLIP baseline (``evaluation/clip_baseline.py`` on
``models/clip.py``, ``data/clip_tokenizer.py`` and ``api/hf_dir.py``)
against the JAX package's, which runs Hugging Face ``transformers``: a
random ``CLIPModel`` at toy widths (2 blocks a tower, width 32, 2 heads),
its weights drawn from a numpy seed, saved with ``save_pretrained`` beside
a byte-level ``vocab.json`` with five merges. Both packages read the same
directory offline.

The tokenizer's ids and masks, the image features (at the tower's size
and through the bicubic resize) and text features in f32, the trial
logits, forced-choice accuracy and records, the reader on every weight
format and on the cache layout, ``cli/eval.py --clip_eval`` and the ETL's
default eval-frame scorer. Then the kernel path's dispatch in bf16 at a
width K5's and K6's gates admit.
"""

import json
import os

import numpy as np
import pytest
import torch

# the oracle is the torch CLIP: keep transformers from importing TensorFlow
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from multimodal_baby_tpu.evaluation import clip_baseline as jclip  # noqa: E402
from multimodal_baby_tpu_torch.api import hf_dir  # noqa: E402
from multimodal_baby_tpu_torch.data.clip_tokenizer import (  # noqa: E402
    CLIPTokenizer, bytes_to_unicode)
from multimodal_baby_tpu_torch.evaluation import (  # noqa: E402
    clip_baseline as tclip)
from multimodal_baby_tpu_torch.models import clip as tmodel  # noqa: E402
from multimodal_baby_tpu_torch.models import vision_vit  # noqa: E402
from multimodal_baby_tpu_torch.models.vision_vit import (  # noqa: E402
    ViTKernels)

ATOL = 1e-5
MERGES = [("t", "h"), ("th", "e</w>"), ("p", "h"), ("o", "t"),
          ("ot", "o</w>")]
N_VOCAB = 512 + len(MERGES) + 2    # bytes, bytes</w>, merges, specials
EOS_ID = N_VOCAB - 1
TEXTS = ["a photo of the ball", "The  CAT's  toy!!", "x.'s 12,5 café",
         "hello\tworld\n", "naïve ²3 ½ Ⅻ a²b", "it's we're I'M they'll",
         "", "a_b__c", "¿qué?", "日本語 text", "don't   stop--now...",
         "ΣΑΣ photo", "cafe\u0301 noe\u0308l"]
CATS = ["ball", "car", "cat", "crib", "the dog"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_tokenizer(d):
    base = list(bytes_to_unicode().values())
    vocab = base + [b + "</w>" for b in base] + [a + b for a, b in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(
        f"{a} {b}\n" for a, b in MERGES))


def tiny_clip(eos_token_id=EOS_ID, width=32, heads=2, hidden=64,
              image_size=32, patch=8, seed=0):
    """A random HF CLIPModel: weights N(0, s) from a numpy seed, the
    LayerNorms 1 + 0.1 N and 0.1 N."""
    from transformers import CLIPConfig, CLIPModel
    cfg = CLIPConfig(
        text_config=dict(
            hidden_size=width, intermediate_size=hidden, num_hidden_layers=2,
            num_attention_heads=heads, max_position_embeddings=32,
            vocab_size=N_VOCAB + 3, eos_token_id=eos_token_id),
        vision_config=dict(
            hidden_size=width, intermediate_size=hidden, num_hidden_layers=2,
            num_attention_heads=heads, image_size=image_size,
            patch_size=patch),
        projection_dim=16)
    model = CLIPModel(cfg).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 0:      # logit_scale, which no feature uses
                continue
            if "layer_norm" in name or "layrnorm" in name \
                    or "layernorm" in name:
                v = (1.0 if name.endswith("weight") else 0.0) \
                    + 0.1 * rng.randn(*p.shape)
            else:
                v = rng.randn(*p.shape) * (0.5 if p.dim() == 1 else
                                           p.shape[-1] ** -0.5)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    model = tiny_clip()
    model.save_pretrained(d)
    write_tokenizer(d)
    return d, model


@pytest.fixture(scope="module")
def pair(clip_dir):
    d, model = clip_dir
    j = jclip.CLIPBaseline(model=model, processor_name=str(d))
    t = tclip.CLIPBaseline(model_name=str(d), device="cpu")
    return j, t


def images(n, size, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               np.uint8)


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(pair, text):
    """ids and masks of a padded pair, the other text one of two."""
    j, t = pair
    batch = [text, "a photo of a photo"]
    want = j.tokenizer(batch, padding=True)
    got = t.tokenizer(batch)
    assert got["input_ids"].tolist() == want["input_ids"]
    assert got["attention_mask"].tolist() == want["attention_mask"]


@pytest.mark.parametrize("size", [32, 48])
def test_image_features_match_jax(pair, size):
    """At the tower's 32 px, and from 48 px through the bicubic resize."""
    j, t = pair
    x = images(6, size)
    np.testing.assert_allclose(t.preprocess(x).numpy(),
                               j.preprocess(x).numpy(), atol=ATOL)
    got, want = t.encode_image(x), j.encode_image(x)
    assert got.shape == want.shape == (6, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("eos", [EOS_ID, 2])
def test_text_features_match_jax(tmp_path, eos):
    """Both pooling rules: the first end-of-text id, and (eos_token_id 2)
    the largest id of the row."""
    model = tiny_clip(eos_token_id=eos)
    model.save_pretrained(tmp_path)
    write_tokenizer(tmp_path)
    j = jclip.CLIPBaseline(model=model, processor_name=str(tmp_path))
    t = tclip.CLIPBaseline(model_name=str(tmp_path), device="cpu")
    texts = [f"a photo of a {c}" for c in CATS] + TEXTS
    np.testing.assert_allclose(t.encode_text(texts), j.encode_text(texts),
                               atol=ATOL)


def test_trial_logits_match_jax(pair):
    j, t = pair
    trials = images(12, 40).reshape(3, 4, 40, 40, 3)
    labels = [f"a photo of a {c}" for c in CATS[:3]]
    np.testing.assert_allclose(t.score_image_trials(trials, labels),
                               j.score_image_trials(trials, labels),
                               atol=ATOL)


def test_forced_choice_matches_jax(pair):
    """Accuracy and records over 19 trials (two batches of 16), target
    first."""
    j, t = pair
    dataset = [(images(4, 40, seed=10 + i), None, None, CATS[i % 5])
               for i in range(19)]
    got = tclip.run_clip_forced_choice(t, dataset)
    want = jclip.run_clip_forced_choice(j, dataset)
    assert got == want and len(got[1]) == 19


@pytest.mark.parametrize("form", ["f32", "f16", "bf16", "bin"])
def test_reader_matches_transformers(tmp_path, form):
    """``save_pretrained`` in f32, f16, bf16 (safetensors) and as
    ``pytorch_model.bin``: the reader's tensors equal transformers' own
    load of the directory, and so do the features."""
    model = tiny_clip(seed=5)
    dtype = {"f16": torch.float16, "bf16": torch.bfloat16}.get(form)
    if dtype is not None:
        model = model.to(dtype)
    model.save_pretrained(tmp_path, safe_serialization=form != "bin")
    assert (tmp_path / ("pytorch_model.bin" if form == "bin"
                        else "model.safetensors")).is_file()
    write_tokenizer(tmp_path)
    loaded = transformers.CLIPModel.from_pretrained(tmp_path).float().eval()
    state = hf_dir.read_state_dict(tmp_path)
    for name, p in loaded.state_dict().items():
        if name in state:
            np.testing.assert_array_equal(state[name], p.numpy(), name)
    j = jclip.CLIPBaseline(model=loaded, processor_name=str(tmp_path))
    t = tclip.CLIPBaseline(model_name=str(tmp_path), device="cpu")
    x = images(4, 32)
    np.testing.assert_allclose(t.encode_image(x), j.encode_image(x),
                               atol=ATOL)
    np.testing.assert_allclose(t.encode_text(CATS), j.encode_text(CATS),
                               atol=ATOL)


def test_safetensors_writer_round_trip(tmp_path):
    """The port's writer, read back by the safetensors library and by the
    port's reader: f32, f16, bf16 and int64, bit for bit."""
    from safetensors.torch import load_file
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g),
               "b.c": torch.randn(7, generator=g).half(),
               "d": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "e": torch.arange(6).reshape(2, 3)}
    hf_dir.write_safetensors(tmp_path / "x.safetensors", tensors)
    back = load_file(tmp_path / "x.safetensors")
    mine = hf_dir.read_safetensors(tmp_path / "x.safetensors")
    assert sorted(back) == sorted(mine) == sorted(tensors)
    for name, want in tensors.items():
        assert back[name].dtype == want.dtype
        assert torch.equal(back[name], want), name
        np.testing.assert_array_equal(
            mine[name], (want.float() if want.is_floating_point()
                         else want).numpy(), name)


def test_reader_resolves_the_cache_layout(clip_dir, tmp_path, monkeypatch):
    """A name in the Hugging Face cache resolves to its refs/main snapshot,
    as ``from_pretrained`` resolves it offline."""
    import shutil
    d, model = clip_dir
    repo = tmp_path / "hf" / "hub" / "models--someorg--tiny-clip"
    snapshot = repo / "snapshots" / "0123abcd"
    shutil.copytree(d, snapshot)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abcd")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert hf_dir.resolve_model_dir("someorg/tiny-clip") == snapshot
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hf" / "hub"))
    monkeypatch.delenv("HF_HOME")
    t = tclip.CLIPBaseline(model_name="someorg/tiny-clip", device="cpu")
    j = jclip.CLIPBaseline(model=model, processor_name=str(d))
    x = images(2, 32)
    np.testing.assert_allclose(t.encode_image(x), j.encode_image(x),
                               atol=ATOL)


def test_reader_refuses_an_unknown_name(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="does not download"):
        hf_dir.resolve_model_dir("openai/clip-vit-large-patch14")
    with pytest.raises(FileNotFoundError, match="does not download"):
        tclip.CLIPBaseline(model_name=str(tmp_path / "nowhere"),
                           device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf_dir.read_state_dict(tmp_path / "empty")


def test_refusals(clip_dir):
    """The card unless asked, no int8 or LN-fold, no unknown activation,
    and a strict state dict."""
    d, _ = clip_dir
    config = hf_dir.read_config(d)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodel.CLIPModel(config)
    with pytest.raises(ValueError, match="int8 or LN-fold"):
        tmodel.CLIPModel(config, device="cpu",
                         kernels=ViTKernels(lnfold=True))
    bad = {**config, "vision_config": {**config["vision_config"],
                                       "hidden_act": "relu"}}
    with pytest.raises(ValueError, match="hidden_act"):
        tmodel.CLIPModel(bad, device="cpu")
    state = hf_dir.read_state_dict(d)
    state.pop("text_projection.weight")
    with pytest.raises(KeyError, match="text_projection"):
        tmodel.clip_from_state(config, state, device="cpu")


def write_eval_dir(root, rng):
    """Five categories of two 224 px PNG frames and 10 four-way trials
    (eval_filtered_dev.json), as the forced-choice datasets read them."""
    from PIL import Image
    paths = {}
    for c in CATS:
        paths[c] = []
        for k in range(2):
            p = root / f"{c.replace(' ', '_')}_{k}.png"
            Image.fromarray(rng.randint(0, 256, (224, 224, 3), np.uint8)
                            ).save(p)
            paths[c].append(str(p))
    trials = []
    for i in range(10):
        target = CATS[i % 5]
        foils = [c for c in CATS if c != target][:3]
        trials.append({"trial_num": i, "target_category": target,
                       "target_img_filename": paths[target][i % 2],
                       "foil_categories": foils,
                       "foil_img_filenames": [paths[c][0] for c in foils]})
    (root / "eval_filtered_dev.json").write_text(json.dumps({"data": trials}))


def test_cli_clip_eval_matches_jax(clip_dir, tmp_path, capsys):
    """``cli/eval.py --clip_eval --clip_model <dir>`` of both packages on
    one eval directory: the same accuracy, printed alike."""
    from multimodal_baby_tpu.cli import eval as jeval
    from multimodal_baby_tpu_torch.cli import eval as teval
    d, _ = clip_dir
    write_eval_dir(tmp_path, np.random.RandomState(4))
    argv = ["--checkpoint", "unused", "--clip_eval", "--clip_model", str(d),
            "--data_dir", str(tmp_path), "--batch_size", "4"]
    want = jeval.main(argv)
    printed = capsys.readouterr().out
    got = teval.main(argv + ["--device", "cpu"])
    assert got == want and 0.0 <= got["total"] <= 1.0
    assert capsys.readouterr().out == printed


def test_etl_default_scorer_matches_jax(clip_dir, tmp_path, monkeypatch):
    """``filter_eval_frames`` with no scorer: the port builds its ViT-B/16
    baseline from the Hugging Face cache (here the toy model under
    ``openai/clip-vit-base-patch16`` in a temporary HF_HOME); the JAX
    function gets its default scorer's code on the same model. The same
    frames are kept."""
    import shutil
    from PIL import Image
    from multimodal_baby_tpu.data import etl as jetl
    from multimodal_baby_tpu_torch.data import etl as tetl
    d, model = clip_dir
    rng = np.random.RandomState(6)
    labeled = tmp_path / "labeled"
    for c in CATS + ["couch"]:
        (labeled / c).mkdir(parents=True)
        for k in range(3):
            Image.fromarray(rng.randint(0, 256, (40, 40, 3), np.uint8)
                            ).save(labeled / c / f"{k}.png")
    repo = tmp_path / "hf" / "hub" / "models--openai--clip-vit-base-patch16"
    shutil.copytree(d, repo / "snapshots" / "main0")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("main0")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    kept = tetl.filter_eval_frames(labeled, tmp_path / "port", device="cpu")

    clip = jclip.CLIPBaseline(model=model, processor_name=str(d))
    cats = sorted(c for c in CATS if c not in jetl.EXCLUDED_EVAL_CATEGORIES)
    text_features = clip.encode_text(cats)

    def scorer(images_u8, _):
        return (clip.encode_image(images_u8) @ text_features.T).argmax(-1)

    assert kept == jetl.filter_eval_frames(labeled, tmp_path / "jax",
                                           scorer=scorer) > 0
    listing = {name: sorted(str(p.relative_to(tmp_path / name))
                            for p in (tmp_path / name).rglob("*"))
               for name in ("port", "jax")}
    assert listing["port"] == listing["jax"]


def test_kernel_path_dispatch(tmp_path, monkeypatch):
    """In bf16 at width 128 (2 heads of 64, MLP 512, 17 tokens), where K5's
    and K6's gates admit the shape, every vision block takes K5 then K6
    with CLIP's eps (1e-5) and GELU form (quick_gelu: "sigmoid"), whose
    plain versions run on the CPU; the features stay within cosine 0.999
    of the JAX package's f32 ones."""
    model = tiny_clip(width=128, heads=2, hidden=512, seed=7)
    model.save_pretrained(tmp_path)
    write_tokenizer(tmp_path)
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, args[-2:]))   # (kv_valid, eps), (eps, GELU)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(vision_vit, "fused_block_attention", spy(
        "K5", vision_vit.fused_block_attention))
    monkeypatch.setattr(vision_vit, "fused_mlp",
                        spy("K6", vision_vit.fused_mlp))
    t = tclip.CLIPBaseline(model_name=str(tmp_path), device="cpu",
                           dtype=torch.bfloat16)
    j = jclip.CLIPBaseline(model=model, processor_name=str(tmp_path))
    x = images(4, 48)
    got, want = t.encode_image(x), j.encode_image(x)
    assert calls == [("K5", (None, 1e-5)), ("K6", (1e-5, "sigmoid"))] * 2
    assert (got * want).sum(1).min() >= 0.999
