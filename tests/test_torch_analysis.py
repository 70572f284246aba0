"""The port's analyses that run a model, and the host code beside them,
against the JAX package's.

A toy-trunk model (``TinyConvNet``: a 4x4 feature map at 128 px) with the
LSTM text encoder (vocab 32, E = H = 16), initialised by the JAX package
and moved through ``api/convert.py``, in f32 on the CPU:

- the bicubic resize within 1e-6 of ``jax.image.resize`` at 7 -> 224,
  2 -> 64 and 1 -> 8 (and a downsampling 14 -> 7);
- ``grad_cam`` (B = 3) and ``grad_cam_captioning`` (every step of one
  caption) within 1e-5 of the JAX package's maps;
- ``get_attention_overlay``, ``rsa`` (Pearson and Spearman), the n-gram
  LM (N = 1, 2, 3) and the leak audit's report and CSV equal to the JAX
  package's;
- the alignment CSVs and the t-SNE CSV written by both packages from the
  same features, equal (the contracts of tests/test_analysis.py:185-245);
  ``category_feature_sets`` and ``extract_joint_embeddings`` within 1e-5;
- ``collect_token_data``: token ids and positions equal, cross-entropy and
  hidden states within 1e-5; ``sentence_batches`` equal;
- ``cli/analyze.py alignment`` and ``duplicates`` end to end on a toy
  checkpoint directory with ``--device cpu``, the other subcommands
  running (no longer refused); ``cli/eval.py --dump_attention_maps``
  writing its overlays.
"""

import json
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.analysis import attention_maps as jam
from multimodal_baby_tpu.analysis import duplicates as jdup
from multimodal_baby_tpu.analysis import embeddings as jemb
from multimodal_baby_tpu.analysis import processing as jproc
from multimodal_baby_tpu.analysis.ngram import NGramModel as JNGram
from multimodal_baby_tpu.analysis.representation_similarity import (
    rsa as j_rsa)
from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.data.augment import normalize_image as j_normalize
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu_torch.analysis import attention_maps as tam
from multimodal_baby_tpu_torch.analysis import duplicates as tdup
from multimodal_baby_tpu_torch.analysis import embeddings as temb
from multimodal_baby_tpu_torch.analysis import processing as tproc
from multimodal_baby_tpu_torch.analysis.ngram import NGramModel
from multimodal_baby_tpu_torch.analysis.representation_similarity import rsa
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.cli import analyze
from multimodal_baby_tpu_torch.cli import eval as teval
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data.augment import normalize_image
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train.checkpoint import CheckpointManager

WORDS = ["<pad>", "<unk>", "<sos>", "<eos>", "ball", "cat", "kitty", "dog",
         "car", "the", "a", "big", "red", "look", "at", "is", "on", "in",
         "baby", "mommy", "book", "shoe", "hat", "bird", "milk", "truck",
         "see", "you", "it", "go", "up", "here"]
CATS = ["ball", "car", "cat", "dog"]
V, E, IMG = len(WORDS), 16, 128
ATOL = 1e-5


@pytest.fixture
def one_thread():
    """t-SNE on one OpenMP thread: beside the other test workers, a
    thread per core spins against them (minutes instead of a second)."""
    with threadpool_limits(1):
        yield


def model_cfg(captioning=False):
    return jcfg.ModelConfig(
        embedding_dim=E, vocab_size=V, embedding_type="flat",
        normalize_features=True, fix_temperature=True,
        vision=jcfg.VisionConfig(cnn_model="toy"),
        text=jcfg.TextConfig(text_encoder="lstm", captioning=captioning))


_PAIRS = {}


def build_pair(captioning=False):
    """(JAX model, variables, port model) on the JAX package's weights."""
    if captioning not in _PAIRS:
        cfg = model_cfg(captioning)
        model = JCVCL(cfg)
        variables = model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
            jnp.zeros((1, 4), jnp.int32), jnp.ones((1,), jnp.int32),
            method="joint_forward", use_mm=True, use_lm=True)
        params = jax.tree.map(np.asarray, variables["params"])
        _PAIRS[captioning] = (cfg, model, {"params": params})
    cfg, model, variables = _PAIRS[captioning]
    port = CVCL(tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model, device="cpu")
    load_state_dict(port, cvcl_state_dict(variables["params"], {}))
    return model, variables, port


def vocabs():
    word2idx = {w: i for i, w in enumerate(WORDS)}
    return Vocab(dict(word2idx)), JVocab(dict(word2idx))


def images(n, seed=0, size=IMG):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               np.uint8)


# ---------------------------------------------------------------- grad-CAM

@pytest.mark.parametrize("h,out", [(7, 224), (2, 64), (1, 8), (14, 7)])
def test_resize_matches_jax(h, out):
    x = np.random.RandomState(h).rand(3, h, h).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, out, out),
                                       method="bicubic"))
    got = tam.resize_bicubic(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_grad_cam_matches_jax():
    model, variables, port = build_pair()
    u8 = images(3, seed=1)
    text = np.zeros((3, 25), np.int32)
    text[:, 0], text[:, 1], text[:, 2] = 2, [4, 5, 7], 3
    lens = np.full((3,), 3, np.int32)
    want = jam.grad_cam(model, variables, j_normalize(jnp.asarray(u8)),
                        jnp.asarray(text), jnp.asarray(lens))
    got = tam.grad_cam(port, normalize_image(torch.from_numpy(u8)),
                       torch.from_numpy(text).long(),
                       torch.from_numpy(lens).long())
    assert got.shape == want.shape == (3, IMG, IMG)
    assert 0 <= got.min() and got.max() <= 1 + 1e-6
    assert (got.reshape(3, -1).max(1) > 0.99).all()  # a map each
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_grad_cam_captioning_matches_jax():
    model, variables, port = build_pair(captioning=True)
    u8 = images(1, seed=2)[0]
    text = np.zeros((10,), np.int32)
    text[:6] = [2, 4, 9, 11, 5, 3]
    want = jam.grad_cam_captioning(
        model, variables, j_normalize(jnp.asarray(u8)), text, 6, out_size=32)
    got = tam.grad_cam_captioning(
        port, normalize_image(torch.from_numpy(u8)), text, 6, out_size=32)
    assert got.shape == want.shape == (6, 32, 32)
    assert np.all(got[0] == 0) and 0 <= got.min() and got.max() <= 1 + 1e-6
    assert (got[1:].reshape(5, -1).max(1) > 0.99).all()  # a map a step
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_grad_cam_refuses_a_vit():
    vit = SimpleNamespace(cfg=SimpleNamespace(
        vision=SimpleNamespace(vit_dino=True)))
    with pytest.raises(ValueError, match="CNN backbone"):
        tam._feature_map(vit, torch.zeros(1, 14, 14, 3))


@pytest.mark.parametrize("sigma", [0.0, 0.02, 0.1])
def test_attention_overlay_equals_jax(sigma):
    rng = np.random.RandomState(3)
    img, att = rng.rand(48, 48, 3).astype(np.float32), rng.rand(48, 48)
    np.testing.assert_array_equal(
        tam.get_attention_overlay(img, att, sigma),
        jam.get_attention_overlay(img, att, sigma))


# ------------------------------------------------------ host-side analyses

@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_rsa_equals_jax(method):
    rng = np.random.RandomState(4)
    x, y = rng.randn(20, 16), rng.randn(20, 8)
    rotated = x @ np.linalg.qr(rng.randn(16, 16))[0]
    for a, b in ((x, y), (x, rotated)):
        assert rsa(a, b, method) == j_rsa(a, b, method)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_equals_jax(n):
    rng = np.random.RandomState(n)
    y = rng.randint(4, V, (12, 9))
    y[:, 0] = 2
    y_len = rng.randint(2, 10, 12)
    ours, theirs = NGramModel(n, V), JNGram(n, V)
    for m in (ours, theirs):
        m.update(y[:8], y_len[:8])
    for kw in (dict(), dict(alpha=0.3), dict(tokenwise=False)):
        np.testing.assert_array_equal(
            ours.calculate_ce_loss(y[8:], y_len[8:], **kw),
            theirs.calculate_ce_loss(y[8:], y_len[8:], **kw))


def leak_metadata():
    train_md = [{"utterance": "look at the ball",
                 "frame_filenames": ["t0.jpg", "t1.jpg"]},
                {"utterance": "a cat", "frame_filenames": ["t2.jpg"]},
                {"utterance": "the cat and the ball",
                 "frame_filenames": ["t3.jpg"]}]
    eval_md = [{"target_category": "ball", "target_img_filename": "e0.jpg"},
               {"target_category": "cat", "target_img_filename": "e1.jpg"},
               {"target_category": "cat", "target_img_filename": "e2.jpg"},
               {"target_category": "dog", "target_img_filename": "e3.jpg"}]
    rng = np.random.RandomState(5)
    feats = {f: rng.randn(6) for f in ("t0.jpg", "t1.jpg", "t2.jpg",
                                       "t3.jpg", "e1.jpg", "e2.jpg",
                                       "e3.jpg")}
    feats["e0.jpg"] = feats["t1.jpg"] + 0.01 * rng.randn(6)
    return train_md, eval_md, lambda paths: np.stack([feats[p]
                                                      for p in paths])


def test_leak_audit_equals_jax(tmp_path):
    train_md, eval_md, embed = leak_metadata()
    want = jdup.run_leak_audit(train_md, eval_md, embed, tmp_path / "j")
    got = tdup.run_leak_audit(train_md, eval_md, embed, tmp_path / "t")
    assert got == want and got["per_category"]["ball"]["n_over"]["0.99"]
    for name in ("matched_results.csv", "duplicates_report.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_alignment_csvs_equal_jax(tmp_path, one_thread):
    rng = np.random.RandomState(6)
    C, N = 4, 16
    mean_img = rng.randn(C, E)
    txt = mean_img + 0.3 * rng.randn(C, E)
    img = rng.randn(N, E)
    img_cats = [CATS[i % C] for i in range(N)]
    files = [f"{c}/f{i}.png" for i, c in enumerate(img_cats)]
    out = {}
    for name, mod in (("j", jemb), ("t", temb)):
        d = tmp_path / name
        out[name] = (
            mod.write_alignment_csvs(mean_img, txt, CATS, d, model="cvc",
                                     seed=0)[2],
            mod.write_joint_embeddings_with_eval_sims(
                img, mean_img, txt, img_cats, files, CATS,
                d / "cvc_joint_embeddings_with_eval_sims_seed_0.csv"))
    assert out["t"][0] == out["j"][0]
    pd.testing.assert_frame_equal(out["t"][1], out["j"][1])
    for f in sorted(p.name for p in (tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    joint = {"image_embeddings": img, "text_embeddings": mean_img,
             "categories": np.asarray(img_cats),
             "category_names": np.asarray(CATS)}
    pd.testing.assert_frame_equal(temb.alignment_table(joint),
                                  jemb.alignment_table(joint))
    np.testing.assert_array_equal(temb.tsne_coordinates(joint),
                                  jemb.tsne_coordinates(joint))


def write_frames(root, per_cat=(5, 3, 4, 2)):
    """Category directories of PNG frames at 64 px (resized to 224 on
    read, as the reference's frames are)."""
    rng = np.random.RandomState(7)
    for cat, n in zip(CATS, per_cat):
        (root / cat).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
                root / cat / f"{cat}_{i}.png")
    return root


def test_category_feature_sets_match_jax(tmp_path):
    model, variables, port = build_pair()
    vocab, jvocab = vocabs()
    frames = write_frames(tmp_path / "frames")
    kw = dict(n_samples=4, seed=3, batch_size=3)
    want = jemb.category_feature_sets(model, variables, frames, jvocab, **kw)
    got = temb.category_feature_sets(port, frames, vocab, **kw)
    assert sorted(got) == sorted(want)
    for k in ("image_categories", "image_filenames", "categories"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["all_image_features"].shape == (13, E)
    for k in ("all_image_features", "mean_image_features", "text_features"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


class Trials:
    """image-mode trial items: (images [4, H, W, 3], ids, length, cat)."""

    def __init__(self, vocab, n=6):
        rng = np.random.RandomState(8)
        self.vocab = vocab
        self.items = []
        for t in range(n):
            ids = np.zeros((25,), np.int32)
            cat = CATS[t % 4]
            ids[:3] = [2, vocab[cat], 3]
            self.items.append((images(4, seed=t, size=64), ids, 3, cat))
        self.data = [None] * n

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_extract_joint_embeddings_matches_jax():
    model, variables, port = build_pair()
    vocab, jvocab = vocabs()
    want = jemb.extract_joint_embeddings(model, variables, Trials(jvocab),
                                         batch_size=4)
    got = temb.extract_joint_embeddings(port, Trials(vocab), batch_size=4)
    for k in ("categories", "category_names"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("image_embeddings", "text_embeddings"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


# --------------------------------------------------------------- processing

UTTERANCES = ["look at the big ball", "a cat", "the dog is on the car",
              "see you", "mommy look at the red truck and the bird up here",
              "zzz baby", "hat"]


def test_collect_token_data_matches_jax():
    model, variables, port = build_pair()
    vocab, jvocab = vocabs()
    jb = list(jproc.sentence_batches(UTTERANCES, jvocab, batch_size=3,
                                     max_len=12))
    tb = list(tproc.sentence_batches(UTTERANCES, vocab, batch_size=3,
                                     max_len=12))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        for k in ("text", "text_len"):
            np.testing.assert_array_equal(a[k], b[k])
    want = jproc.collect_token_data(model, variables, jb, jvocab,
                                    collect_hidden=True)
    got = tproc.collect_token_data(port, tb, vocab, collect_hidden=True)
    for k in ("token_id", "position", "token"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("ce_loss", "hidden"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    assert got["hidden"].shape == (len(want["token"]), E)
    summary = tproc.per_word_summary(got)
    pd.testing.assert_frame_equal(
        summary.drop(columns="mean_ce"),
        jproc.per_word_summary(want).drop(columns="mean_ce"))
    hid, jhid = (mod.mean_hidden_per_word(d) for mod, d in
                 ((tproc, got), (jproc, want)))
    np.testing.assert_array_equal(hid["words"], jhid["words"])
    np.testing.assert_allclose(hid["mean_hidden"], jhid["mean_hidden"],
                               atol=ATOL, rtol=0)


# --------------------------------------------------------------------- CLIs

def toy_checkpoint(root):
    """A checkpoint directory of the port's trainer holding the toy model."""
    _, _, port = build_pair()
    cfg = tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=model_cfg()).to_json())
    mgr = CheckpointManager(root)
    mgr.save({"model": port.state_dict()}, 0, 1.0, cfg)
    mgr.wait()
    Vocab(dict(zip(WORDS, range(V)))).save(root / "vocab.json")
    return root, port


def test_cli_alignment_end_to_end(tmp_path, one_thread):
    ckpt, port = toy_checkpoint(tmp_path / "ckpt")
    frames = write_frames(tmp_path / "frames")
    out = tmp_path / "out"
    feats = analyze.main(["alignment", "--checkpoint", str(ckpt),
                          "--eval_frames_dir", str(frames), "--out_dir",
                          str(out), "--seed", "1", "--device", "cpu"])
    want = temb.category_feature_sets(port, frames, vocabs()[0], seed=1)
    np.testing.assert_array_equal(feats["all_image_features"],
                                  want["all_image_features"])
    assert sorted(p.name for p in out.iterdir()) == [
        "cvc_image_text_embeddings_sims_seed_1.csv",
        "cvc_joint_embeddings_sims_seed_1.csv",
        "cvc_joint_embeddings_with_eval_sims_seed_1.csv"]
    df = pd.read_csv(out / "cvc_joint_embeddings_with_eval_sims_seed_1.csv")
    assert list(df.columns) == ["x", "y", "eval_category", "image_filename",
                                "embedding_type"] + CATS
    assert len(df) == 14 + 2 * len(CATS)


def test_cli_duplicates_end_to_end(tmp_path):
    ckpt, port = toy_checkpoint(tmp_path / "ckpt")
    data = tmp_path / "data"
    (data / "train_5fps").mkdir(parents=True)
    rng = np.random.RandomState(9)
    for i in range(5):
        Image.fromarray(rng.randint(0, 256, (32, 32, 3), np.uint8)).save(
            data / "train_5fps" / f"f{i}.png")
    train_md = [{"utterance": "the ball", "frame_filenames": ["f0.png",
                                                            "f1.png"]},
                {"utterance": "a cat", "frame_filenames": ["f2.png"]}]
    eval_md = [{"target_category": "ball", "target_img_filename": "f3.png"},
               {"target_category": "cat", "target_img_filename": "f4.png"}]
    (data / "train.json").write_text(json.dumps({"data": train_md}))
    (data / "eval_filtered_test.json").write_text(
        json.dumps({"data": eval_md}))
    report = analyze.main(["duplicates", "--checkpoint", str(ckpt),
                           "--data_dir", str(data), "--out_dir",
                           str(tmp_path / "dup"), "--device", "cpu"])
    assert report["n_pairs"] == 2
    load = analyze.frame_loader(data / "train_5fps")
    embed = analyze.frame_embedder(port, load)
    want = jdup.run_leak_audit(train_md, eval_md, embed, tmp_path / "want")
    assert report == want
    assert (tmp_path / "dup" / "nn_pairs.png").exists()


@pytest.mark.parametrize("cmd", ["summaries", "descriptives", "figures"])
def test_cli_analyze_refuses_the_csv_contracts(cmd, tmp_path, capsys):
    """The CSV-contract subcommands no longer refuse: each runs on small
    inputs and writes its artifact (tests/test_torch_analysis_host.py
    holds them equal to the JAX package's)."""
    (tmp_path / "train.json").write_text(json.dumps({"data": [
        {"utterance": "the ball", "frame_filenames": ["f.png"]}]}))
    csv = tmp_path / "summary.csv"
    pd.DataFrame({"target_category": ["ball", "cat"], "correct": [1, 0],
                  "config": ["a", "a"], "seed": [0, 0]}).to_csv(csv)
    argv = {"summaries": ["--results_dir", str(tmp_path)],
            "descriptives": ["--data_dir", str(tmp_path), "--out_csv",
                             str(tmp_path / "d.csv")],
            "figures": ["--summary_csv", str(csv), "--out_dir",
                        str(tmp_path / "figs")]}[cmd]
    analyze.main([cmd, *argv])
    assert "not ported" not in capsys.readouterr().err
    assert {"summaries": tmp_path / "summary" / "object-categories.csv",
            "descriptives": tmp_path / "d.csv",
            "figures": tmp_path / "figs" / "eval_accuracy.png"}[cmd].exists()


def test_cli_eval_dumps_attention_maps(tmp_path):
    _, _, port = build_pair()
    vocab, _ = vocabs()
    trials = Trials(vocab, n=3)
    teval.dump_attention_maps(port, trials, 2, tmp_path / "maps")
    names = sorted(p.name for p in (tmp_path / "maps").iterdir())
    assert names == [f"trial{i}_{CATS[i]}_img{j}.png" for i in range(2)
                     for j in range(4)]
    imgs, ids, ln, cat = trials[1]
    cams = tam.grad_cam(port, normalize_image(torch.from_numpy(imgs)),
                        torch.from_numpy(ids).long()[None].expand(4, -1),
                        torch.full((4,), ln))
    want = tam.get_attention_overlay(imgs[2].astype(np.float32) / 255.0,
                                     cams[2])
    got = np.asarray(Image.open(tmp_path / "maps" / names[6]))
    np.testing.assert_array_equal(
        got, (np.clip(want, 0, 1) * 255).astype(np.uint8))
