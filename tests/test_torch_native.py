"""The port's host input path against the JAX package's: the native C++
decoder (``data/native``; its source a byte copy of the JAX package's),
the datasets that decode with it, and ``device_batch`` on the CPU.

Images: ``tests/test_native_pipeline.py``'s fixture (a 224 px PNG, a JPEG
at quality 95, a 640 x 480 PNG) plus a 256 px JPEG of low-frequency noise
(``bench.py``'s frames: the DCT-scaled decode lands on 224) and a
non-square JPEG, a GIF (PIL reads it, the native decoder does not), a
corrupt JPEG and a missing file. Frames must be equal byte for byte, in
both decode modes; the JAX side's mode is set by ``MMB_FAST_DECODE``.
"""

import filecmp
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_baby_tpu.data import datasets as jds
from multimodal_baby_tpu.data import native as jnat
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu_torch.data import datasets as tds
from multimodal_baby_tpu_torch.data import modules as tmodules
from multimodal_baby_tpu_torch.data import native
from multimodal_baby_tpu_torch.core.config import DataConfig
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.train.step import device_batch

REPO = Path(__file__).resolve().parents[1]
DECODED = ("png", "jpg", "resize", "jpg256", "wide")  # both decoders read


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (224, 224, 3), np.uint8)
    Image.fromarray(arr).save(d / "a.png")
    Image.fromarray(arr).save(d / "a.jpg", quality=95)
    Image.fromarray(rng.randint(0, 255, (480, 640, 3), np.uint8)).save(
        d / "big.png")
    for name, (h, w) in (("jpg256", (256, 256)), ("wide", (200, 300))):
        low = rng.randint(0, 256, (16, 16, 3), np.uint8)
        img = np.asarray(Image.fromarray(low).resize((w, h),
                                                     Image.BILINEAR))
        img = np.clip(img.astype(np.int16)
                      + rng.randint(-12, 13, img.shape, np.int16), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(d / f"{name}.jpg",
                                                   quality=90)
    Image.fromarray(arr).save(d / "frame.gif")
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(200))
    return {"png": str(d / "a.png"), "jpg": str(d / "a.jpg"),
            "resize": str(d / "big.png"), "jpg256": str(d / "jpg256.jpg"),
            "wide": str(d / "wide.jpg"), "gif": str(d / "frame.gif"),
            "corrupt": str(d / "corrupt.jpg"),
            "missing": str(d / "missing.jpg")}


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's decoder, loaded. Its loader builds the library
    next to its source with no lock across processes (ROADMAP F2): a
    process that finds another's half-written library gives up for good,
    so wait for the build that is under way and load again."""
    deadline = time.monotonic() + 60
    while not jnat.available():
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native decoder did not load")
        time.sleep(1)
        jnat._TRIED = False
    return jnat


def test_source_is_a_byte_copy():
    assert filecmp.cmp(native.SOURCE, REPO / "multimodal_baby_tpu" / "data"
                       / "native" / "image_pipeline.cc", shallow=False)


@pytest.mark.parametrize("fast", [True, False])
def test_decode_image_matches_jax(images, jax_native, monkeypatch, fast):
    """Every image, one by one, in the decode mode ``fast``; None for the
    files the decoder does not read, in both packages."""
    assert native.available(), native.build_error()
    monkeypatch.setenv("MMB_FAST_DECODE", "1" if fast else "0")
    for name, path in images.items():
        got = native.decode_image(path, 224, fast=fast)
        want = jax_native.decode_image(path, 224)
        if name in DECODED:
            assert got.shape == (224, 224, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got is None and want is None, name
    # the PNG at the target size is its pixels exactly
    np.testing.assert_array_equal(
        native.decode_image(images["png"], 224, fast=fast),
        np.asarray(Image.open(images["png"])))


@pytest.mark.parametrize("fast", [True, False])
def test_decode_batch_checked_matches_jax(images, jax_native, monkeypatch,
                                          fast):
    """One batch of every file, twice over: the same frames and the same
    mask (0 for the GIF, the corrupt and the missing file, which are
    zero-filled); ``decode_batch`` gives the same frames."""
    monkeypatch.setenv("MMB_FAST_DECODE", "1" if fast else "0")
    paths = list(images.values()) * 2
    got, ok = native.decode_batch_checked(paths, 224, n_threads=3,
                                          fast=fast)
    want, want_ok = jax_native.decode_batch_checked(paths, 224, n_threads=3)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(ok, [n in DECODED for n in images] * 2)
    np.testing.assert_array_equal(got, want)
    assert not got[ok == 0].any()
    np.testing.assert_array_equal(
        native.decode_batch(paths, 224, fast=fast), got)


def test_fast_decode_is_an_argument(images, monkeypatch):
    """The environment does not choose the decode mode: fast is the
    default whatever MMB_FAST_DECODE says, and the two modes differ on
    the 256 px JPEG."""
    fast = native.decode_image(images["jpg256"], 224, fast=True)
    exact = native.decode_image(images["jpg256"], 224, fast=False)
    assert not np.array_equal(fast, exact)
    monkeypatch.setenv("MMB_FAST_DECODE", "0")
    np.testing.assert_array_equal(native.decode_image(images["jpg256"]),
                                  fast)
    np.testing.assert_array_equal(tds.load_image_uint8(images["jpg256"]),
                                  fast)


BUILD_PROBE = """
import sys
from pathlib import Path
from multimodal_baby_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.available(), native.library_path(), native.build_error())
"""


def test_concurrent_builds_load_one_library(tmp_path):
    """Four processes that build the decoder into one empty directory at
    once all load it; one library is left there, and no temporary file.
    A changed source gets another library name."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_PROBE,
                               str(tmp_path)], cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lib = tmp_path / native.library_path().name
    assert outs == [["True", str(lib), "None"]] * 4
    assert list(tmp_path.iterdir()) == [lib]

    edited = tmp_path / "image_pipeline.cc"
    edited.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    name = native.library_path().name
    original = native.SOURCE
    try:
        native.SOURCE = edited
        assert native.library_path().name != name
    finally:
        native.SOURCE = original


def write_paired(root, images, n=8):
    """Training metadata over the decodable frames and the GIF (multi-
    and single-frame entries), and eval trials over the JPEG frames."""
    rng = np.random.RandomState(1)
    frames = [images[k] for k in ("png", "jpg", "resize", "jpg256", "wide",
                                  "gif")]
    words = ["ball", "cat", "look", "the", "car", "kitty"]
    data = []
    for i in range(n):
        utt = " ".join(rng.choice(words, rng.randint(1, 5)))
        if i % 3 == 2:
            data.append({"utterance": utt,
                         "frame_filename": frames[i % len(frames)]})
        else:
            data.append({"utterance": utt, "frame_filenames": [
                frames[j] for j in rng.choice(len(frames), 3)]})
    trials = [{"target_category": c,
               "target_img_filename": frames[(i + 3) % 5],
               "foil_categories": ["car", "cat", "look"],
               "foil_img_filenames": [frames[(i + k) % 5]
                                      for k in range(3)]}
              for i, c in enumerate(["ball", "kitty", "the"])]
    vocab = {w: i for i, w in enumerate(
        ["<pad>", "<unk>", "<sos>", "<eos>"] + words)}
    return data, trials, vocab


@pytest.mark.parametrize("fast", [True, False])
def test_datasets_match_jax(images, jax_native, tmp_path, monkeypatch,
                            fast):
    """``PairedImageTextDataset`` item by item and through
    ``batch_items`` (a GIF slot warns and is filled by PIL, in both
    packages), ``EvalTrialDataset`` and ``TextEvalTrialDataset``: equal to
    the JAX package's on the same metadata, in the decode mode ``fast``;
    the DataModule hands ``fast_decode`` to every dataset."""
    monkeypatch.setenv("MMB_FAST_DECODE", "1" if fast else "0")
    data, trials, words = write_paired(tmp_path, images)
    tv, jv = Vocab(words), JVocab(words)
    kw = dict(multiple_frames=True, seed=3)
    t = tds.PairedImageTextDataset(data, tv, fast_decode=fast, **kw)
    j = jds.PairedImageTextDataset(data, jv, **kw)
    for i in range(len(data)):
        for got, want in zip(t[i], j[i]):
            np.testing.assert_array_equal(got, want)
    idxs = np.asarray([5, 0, 2, 7, 1, 3, 4, 6])
    with pytest.warns(UserWarning, match="native decode failed") as w:
        got = t.batch_items(idxs)
    assert sum("native decode" in str(r.message) for r in w) == 1
    with pytest.warns(UserWarning, match="native decode failed"):
        want = j.batch_items(idxs)
    assert got.keys() == want.keys()
    for k in ("image_u8", "text", "text_len"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["raw"] == want["raw"]
    for tcls, jcls in ((tds.EvalTrialDataset, jds.EvalTrialDataset),
                       (tds.TextEvalTrialDataset, jds.TextEvalTrialDataset)):
        td, jd = tcls(trials, tv, True, fast), jcls(trials, jv, True)
        for i in range(len(trials)):
            for got, want in zip(td[i], jd[i]):
                np.testing.assert_array_equal(got, want)

    root = tmp_path / "dir"
    root.mkdir()
    for name, rows in (("train", data), ("val", data[:3]),
                       ("eval_filtered_dev", trials)):
        (root / f"{name}.json").write_text(json.dumps({"data": rows}))
    tv.save(root / "vocab.json")
    dm = tmodules.DataModule(DataConfig(data_dir=str(root)),
                             fast_decode=fast).setup()
    assert [d.fast_decode for d in (*dm.datasets.values(),
                                    *dm.eval_datasets.values())] == \
        [fast] * 3


def test_a_file_no_decoder_reads_raises(images):
    ds = tds.PairedImageTextDataset(
        [{"utterance": "ball", "frame_filename": images["corrupt"]}],
        Vocab({"<pad>": 0, "<unk>": 1, "<sos>": 2, "<eos>": 3, "ball": 4}))
    with pytest.warns(UserWarning, match="native decode failed"), \
            pytest.raises(Exception, match="cannot identify image file"):
        ds.batch_items(np.asarray([0]))


def test_device_batch_on_the_cpu():
    """The same values and dtypes as one conversion per key: frames
    uint8, int32 ids and lengths widened to int64, other arrays as they
    are; the raw utterances left behind."""
    rng = np.random.RandomState(0)
    batch = {"image_u8": rng.randint(0, 256, (3, 8, 8, 3), np.uint8),
             "text": rng.randint(0, 50, (3, 25)).astype(np.int32),
             "text_len": np.asarray([3, 25, 1], np.int32),
             "valid": np.asarray([True, True, False]),
             "raw": ["a", "b", "c"]}
    out = device_batch(batch, "cpu")
    assert set(out) == {"image_u8", "text", "text_len", "valid"}
    for k, v in out.items():
        want = batch[k].astype(np.int64) if batch[k].dtype == np.int32 \
            else batch[k]
        assert v.device == torch.device("cpu")
        assert v.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(v.numpy(), want)
    assert out["text"].dtype == torch.int64


def test_threaded_loader_draws_frames_as_the_inline_one(images, jax_native,
                                                        monkeypatch):
    """With multiple_frames, the loader's threads get the frames drawn in
    batch order, so a threaded epoch gives the batches of an inline one
    (and of the JAX package's inline loader), with the draws slowed by
    random sleeps to interleave any threads that draw at once."""
    import random
    from multimodal_baby_tpu.data.loader import DataLoader as JLoader
    from multimodal_baby_tpu_torch.data.loader import DataLoader

    frames = [images[k] for k in DECODED]
    rng = np.random.RandomState(4)
    data = [{"utterance": "ball", "frame_filenames": list(
        rng.choice(frames, 4))} for _ in range(48)]
    words = {"<pad>": 0, "<unk>": 1, "<sos>": 2, "<eos>": 3, "ball": 4}

    def epochs(loader_cls, vocab, **kw):
        ds = (tds if loader_cls is DataLoader else jds).PairedImageTextDataset(
            data, vocab, multiple_frames=True, seed=2)
        draw, jitter = ds.frame_filename, random.Random(0)

        def slow_draw(entry):
            time.sleep(jitter.random() * 2e-3)
            return draw(entry)
        ds.frame_filename = slow_draw
        loader = loader_cls(ds, 4, seed=1, num_workers=4, prefetch=4, **kw)
        return [b["image_u8"] for _ in range(2) for b in loader]

    threaded = epochs(DataLoader, Vocab(words))
    inline = epochs(DataLoader, Vocab(words), sync=True)
    monkeypatch.setenv("MMB_LOADER_SYNC", "1")
    jax_inline = epochs(JLoader, JVocab(words))
    assert len(threaded) == len(inline) == len(jax_inline) == 24
    for a, b, c in zip(threaded, inline, jax_inline):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
