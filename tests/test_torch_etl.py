"""The port's offline ETL (``data/etl.py``) against the JAX package's.

One seeded raw SAYCam-format tree (``chip_smoke.write_raw_saycam``: 3
transcripts of 12 rows, 6 categories of 64 px PNG frames and one that the
trials drop, and an .mp4 per transcript as long as it where cv2 here
writes one) goes through both packages' ``prepare_data`` in the same
directory in turn, with the same injected eval-frame scorer; every file
either writes must be equal byte for byte, and a second run of the port's
rewrites nothing. Then the unit cases of ``tests/test_etl.py`` on both
packages (timestamps, cleaning, frame counts, ``extract_frame_array``,
``extract_frames`` on a 3-second .mp4, the injected ``fetch`` and
``scorer``, the 50/50 split), and the port's ``DataModule`` on the
prepared directory against the JAX package's, item by item and batch by
batch.
"""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.data import etl as jetl
from multimodal_baby_tpu.data import loader as jloader
from multimodal_baby_tpu.data import modules as jmodules
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data import etl as tetl
from multimodal_baby_tpu_torch.data import loader as tloader
from multimodal_baby_tpu_torch.data import modules as tmodules
from tests.test_torch_train_data import (
    assert_batches_equal, assert_items_equal)
from tests.torch_jax_decoder import same_decoder

import chip_smoke

WORDS = ["ball", "car", "cat", "dog", "the", "a", "look", "at", "red",
         "kitty", "you", "see", "chair", "sand", "crib"]
CATS = ("ball", "car", "cat", "chair", "crib", "sand", "couch")
ETLS = {"jax": jetl, "port": tetl}


def make_scorer(labeled_s_dir):
    """A deterministic stand-in for the CLIP filter: a frame is 'classified'
    as its own category unless the first byte of its file's digest is a
    multiple of 3, so that about two frames in three are kept."""
    truth = {}
    from PIL import Image
    for d in Path(labeled_s_dir).iterdir():
        for p in d.iterdir():
            img = np.asarray(Image.open(p).convert("RGB"))
            truth[img.tobytes()] = (d.name, hashlib.md5(
                p.read_bytes()).digest()[0] % 3 != 0)

    def scorer(images_u8, categories):
        out = []
        for img in images_u8:
            cat, keep = truth[np.ascontiguousarray(img).tobytes()]
            out.append(categories.index(cat) if keep else -1)
        return np.asarray(out)
    return scorer


def tree_files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' prepare_data on one raw tree: the JAX package's
    output moved to ``jax/``, the port's left in ``data/`` (the path both
    wrote their metadata under), with the mtimes of a second port run."""
    root = tmp_path_factory.mktemp("etl")
    video = chip_smoke.can_write_mp4(root)
    tdir, ldir, vdir = chip_smoke.write_raw_saycam(
        root / "raw", np.random.RandomState(0), WORDS, 3, 12,
        categories=CATS, per_category=5, size=64, video=video)
    scorer = make_scorer(ldir)
    kw = dict(transcript_dir=tdir, video_dir=vdir, labeled_s_dir=ldir,
              clip_scorer=scorer, seed=3)
    data = root / "data"
    jetl.prepare_data(data, **kw)
    shutil.move(data, root / "jax")
    tetl.prepare_data(data, **kw)
    stamps = {f: (data / f).stat().st_mtime_ns for f in tree_files(data)}
    tetl.prepare_data(data, **kw)
    again = {f: (data / f).stat().st_mtime_ns for f in tree_files(data)}
    return {"root": root, "data": data, "jax": root / "jax",
            "video": video, "stamps": stamps, "again": again,
            "raw": (tdir, ldir, vdir)}


def test_prepare_data_byte_equal(prepared):
    """The same files, byte for byte: the metadata JSONs (train, val,
    test, train_shuffled, eval and eval_filtered dev/test), vocab.json,
    the preprocessed CSVs, the split and filtered eval frames and, with
    cv2's video, the extracted frames."""
    data, jax_dir = prepared["data"], prepared["jax"]
    files = tree_files(data)
    assert files == tree_files(jax_dir)
    for name in ("train.json", "val.json", "test.json", "train_shuffled.json",
                 "eval_dev.json", "eval_test.json", "eval_filtered_dev.json",
                 "eval_filtered_test.json", "vocab.json"):
        assert name in files, name
    assert any(f.startswith("preprocessed_transcripts_5fps/") for f in files)
    extracted = [f for f in files if f.startswith("train_5fps/")]
    assert bool(extracted) == prepared["video"]
    for f in files:
        assert (data / f).read_bytes() == (jax_dir / f).read_bytes(), f
    train = json.loads((data / "train.json").read_text())["data"]
    trials = json.loads((data / "eval_dev.json").read_text())["data"]
    assert train and {t["target_category"] for t in trials} == set(
        CATS) - {"couch"}


def test_second_run_rewrites_nothing(prepared):
    assert prepared["again"] == prepared["stamps"]


def test_timestamps_and_cleaning():
    for t in ("1:30", "12:05", "1:30-2:00", "3.15", "2", "1:3", "3.145",
              float("nan"), "", "-1:00", "a:bc", ":30", "1;05", "4,5"):
        assert tetl.convert_timestamp_to_seconds(t) == \
            jetl.convert_timestamp_to_seconds(t), t
    assert tetl.convert_timestamp_to_seconds("1:3") == 90
    for u in ("hello [laughs] world", "so [inaudible] yes",
              "*whispers* hi", "that was inaudible there",
              "(quietly) look (inaudible) at *that*"):
        assert tetl.clean_utterance(u) == jetl.clean_utterance(u), u


@pytest.mark.parametrize("utterance,start,end", [
    ("look at the ball", 10.0, 12.0), ("hi", 0.0, 100.0), ("hi", 5.0, 5.0),
    ("so [inaudible] yes", 0.0, 1.0), ("one. two three! four?", 3.0, 9.0),
    ("[laughs]", 1.0, 2.0)])
def test_preprocess_utterance_matches_jax(utterance, start, end):
    """Sub-utterances, frame timestamps and counts (<= 32 at 5 fps)."""
    t = tetl.preprocess_utterance(utterance, start, end)
    j = jetl.preprocess_utterance(utterance, start, end)
    assert t[0] == j[0] and t[2] == j[2]
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)


def test_extract_frame_array_matches_jax():
    pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    for h, w in ((480, 640), (240, 320), (300, 300), (100, 120)):
        frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t, j = tetl.extract_frame_array(frame), jetl.extract_frame_array(
            frame)
        assert (t is None) == (j is None)
        if j is not None:
            assert t.shape == (224, 224, 3)
            np.testing.assert_array_equal(t, j)
    assert tetl.extract_frame_array(None) is None


def test_extract_frames_matches_jax(prepared, tmp_path):
    """Both packages' extract_frames on one preprocessed CSV and a
    3-second .mp4: the same frames written, byte for byte."""
    if not prepared["video"]:
        pytest.skip("cv2 here writes no .mp4")
    tdir = prepared["raw"][0]
    rows = tetl.preprocess_transcript(tdir / "S_000.csv")
    import pandas as pd
    pre = tmp_path / "pre"
    pre.mkdir()
    pd.DataFrame(rows).to_csv(pre / "S_000.csv", index=False)
    vdir = tmp_path / "videos"
    vdir.mkdir()
    chip_smoke.write_raw_saycam(tmp_path / "raw3", np.random.RandomState(2),
                                WORDS, 1, 2, categories=(), video=True,
                                video_seconds=3)
    shutil.copy(tmp_path / "raw3" / "videos" / "S_000.mp4",
                vdir / "S_000.mp4")
    n = {name: etl.extract_frames(pre, vdir, tmp_path / name)
         for name, etl in ETLS.items()}
    assert n["port"] == n["jax"] > 0
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")
    for f in tree_files(tmp_path / "port"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_download_transcripts_matches_jax(tmp_path):
    """The injected fetch: the same URLs asked, the same files written,
    and a second call skips."""
    links = tmp_path / "links.csv"
    links.write_text(
        "Title,GoogleSheets Link\n"
        "A_001_S,https://docs.google.com/spreadsheets/d/abc123/edit#gid=0\n"
        "A_002_S,https://docs.google.com/spreadsheets/d/def456/edit\n")
    calls = {}
    for name, etl in ETLS.items():
        calls[name] = []

        def fetch(url, log=calls[name]):
            log.append(url)
            return f"Time,Speaker,Utterance\n01:00,M,{url[-20:]}\n".encode()
        out = tmp_path / name
        assert etl.download_transcripts(links, out, fetch=fetch,
                                        sleep_s=0) == 2
        assert etl.download_transcripts(links, out, fetch=fetch,
                                        sleep_s=0) == 0
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")
    for f in tree_files(tmp_path / "port"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_filter_and_split_match_jax(prepared, tmp_path):
    """The injected scorer's filter and the 50/50 dev/test split: the
    same frames kept and the same split, in both packages."""
    ldir = prepared["raw"][1]
    scorer = make_scorer(ldir)
    kept = {}
    for name, etl in ETLS.items():
        kept[name] = etl.filter_eval_frames(ldir, tmp_path / name / "f",
                                            scorer=scorer)
        assert etl.filter_eval_frames(ldir, tmp_path / name / "f",
                                      scorer=scorer) == 0
        etl.split_eval_frames(tmp_path / name / "f",
                              tmp_path / name / "eval", seed=5)
    assert kept["port"] == kept["jax"] > 0
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "jax")
    for cat in CATS[:-1]:
        frames = list((tmp_path / "port" / "f" / cat).iterdir())
        dev = list((tmp_path / "port" / "eval" / "dev" / cat).iterdir())
        assert len(dev) == len(frames) // 2


@pytest.mark.parametrize("eval_type", ["image", "text"])
def test_data_module_matches_jax(prepared, eval_type, monkeypatch):
    """setup() on the prepared directory: the same vocab, datasets and
    eval trials item by item, and the same loader batches (random frame
    draws included), both sides on one decoder
    (``tests/torch_jax_decoder.py``)."""
    if not prepared["video"]:
        pytest.skip("no extracted frames without cv2's video")
    same_decoder(monkeypatch)
    kw = dict(dataset="saycam", data_dir=str(prepared["data"]),
              multiple_frames=True, eval_type=eval_type,
              eval_metadata_filename="eval_filtered_dev.json")
    t = tmodules.DataModule(tcfg.DataConfig(**kw), seed=2).prepare_data()
    j = jmodules.DataModule(jcfg.DataConfig(**kw), seed=2)
    t.setup(), j.setup()
    assert t.vocab.word2idx == j.vocab.word2idx
    assert sorted(t.datasets) == sorted(j.datasets)
    for split in t.datasets:
        for i in range(min(len(j.datasets[split]), 6)):
            assert_items_equal(t.datasets[split][i], j.datasets[split][i])
    assert sorted(t.eval_datasets) == sorted(j.eval_datasets) == [
        "test", "val"]
    for split in t.eval_datasets:
        td, jd = t.eval_datasets[split], j.eval_datasets[split]
        for i in range(0, len(jd), max(1, len(jd) // 4)):
            assert_items_equal(td[i], jd[i])
    kw = dict(shuffle=True, num_workers=2, seed=11)
    got = list(tloader.DataLoader(t.datasets["train"], 8, **kw))
    # one worker: the JAX loader draws frames in its threads' order
    want = list(jloader.DataLoader(j.datasets["train"], 8, shuffle=True,
                                   num_workers=1, seed=11))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
