"""The port's training data layer against the JAX package's: the synthetic
and the paired image-text datasets, the loader's batches and the data
module's assembly of a SAYCam-format directory. Equal means equal to the
last element: the same numpy draws for a seed, and PNG frames at 224 px,
which neither package resizes.
"""

import json

import numpy as np
import pytest

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.data import datasets as jdata
from multimodal_baby_tpu.data import loader as jloader
from multimodal_baby_tpu.data import modules as jmodules
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data import datasets as tdata
from multimodal_baby_tpu_torch.data import loader as tloader
from multimodal_baby_tpu_torch.data import modules as tmodules
from multimodal_baby_tpu_torch.data.vocab import Vocab

WORDS = ["ball", "car", "cat", "dog", "the", "a", "is", "red"]
N_FRAMES = 6


def assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "raw":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("size,image_size", [(8, 224), (5, 16)])
def test_synthetic_dataset_matches_jax(size, image_size):
    t = tdata.SyntheticPairedDataset(size, 64, seed=3,
                                     image_size=image_size)
    j = jdata.SyntheticPairedDataset(size, 64, seed=3,
                                     image_size=image_size)
    for name in ("images", "text", "text_len"):
        assert getattr(t, name).dtype == getattr(j, name).dtype
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert len(t) == len(j) == size
    for i in range(size):
        assert_items_equal(t[i], j[i])


@pytest.fixture(scope="module")
def saycam_dir(tmp_path_factory):
    """A SAYCam-format directory: 224 px PNG frames, train/val/test
    metadata (multi-frame and single-frame entries), eval trials in both
    splits, and the vocab."""
    from PIL import Image
    root = tmp_path_factory.mktemp("saycam")
    rng = np.random.RandomState(0)
    frames = []
    for i in range(N_FRAMES):
        path = root / f"f{i}.png"
        Image.fromarray(rng.randint(0, 256, (224, 224, 3), np.uint8)).save(
            path)
        frames.append(str(path))

    def utterance():
        return " ".join(rng.choice(WORDS + ["zebra"], rng.randint(1, 6)))

    def entries(n):
        out = []
        for i in range(n):
            if i % 3 == 2:
                out.append({"utterance": utterance(),
                            "frame_filename": frames[i % N_FRAMES]})
            else:
                k = rng.randint(2, 5)
                out.append({"utterance": utterance(),
                            "frame_filenames": list(rng.choice(frames, k))})
        return out

    for name, n in (("train", 10), ("val", 4), ("test", 3)):
        (root / f"{name}.json").write_text(json.dumps({"data": entries(n)}))
    trials = [{"target_category": c, "target_img_filename": frames[i],
               "foil_categories": ["car", "cat", "dog"],
               "foil_img_filenames": frames[i + 1:i + 4]}
              for i, c in enumerate(["ball", "red"])]
    for split in ("dev", "test"):
        (root / f"eval_filtered_{split}.json").write_text(
            json.dumps({"data": trials}))
    vocab = Vocab({w: i for i, w in enumerate(
        ["<pad>", "<unk>", "<sos>", "<eos>"] + WORDS)})
    vocab.save(root / "vocab.json")
    return root


@pytest.mark.parametrize("multiple_frames,shuffle", [(True, True),
                                                     (False, False)])
def test_paired_dataset_matches_jax(saycam_dir, multiple_frames, shuffle):
    """The same frames (the frame choice of multiple_frames is the same
    RandomState draw), ids, lengths and utterances (the shuffle_utterances
    permutation too), item by item and through batch_items."""
    meta = tdata.load_metadata(saycam_dir / "train.json")
    assert meta == jdata.load_metadata(saycam_dir / "train.json")
    vocab = Vocab.load(saycam_dir / "vocab.json")
    jvocab = JVocab.load(saycam_dir / "vocab.json")

    def pair():
        kw = dict(multiple_frames=multiple_frames,
                  shuffle_utterances=shuffle, seed=5)
        return (tdata.PairedImageTextDataset(meta, vocab, **kw),
                jdata.PairedImageTextDataset(meta, jvocab, **kw))

    t, j = pair()
    np.testing.assert_array_equal(t.utterance_order, j.utterance_order)
    assert shuffle == (t.utterance_order != np.arange(len(meta))).any()
    for _ in range(2):  # the draws go on alike
        for i in range(len(meta)):
            assert_items_equal(t[i], j[i])
    t, j = pair()
    idxs = np.asarray([3, 0, 7, 7, 1])
    assert_batches_equal(t.batch_items(idxs), j.batch_items(idxs))


@pytest.mark.parametrize("shuffle,drop_last,batch", [
    (True, False, 4), (True, True, 4), (False, False, 3), (False, True, 5)])
def test_loader_matches_jax(shuffle, drop_last, batch):
    """The same batches in the same order over two iterations (each
    shuffles anew from the loader's RandomState), the tail batch kept or
    dropped alike; the synchronous bypass gives the same batches."""
    t_ds = tdata.SyntheticPairedDataset(11, 40, seed=1, image_size=8)
    j_ds = jdata.SyntheticPairedDataset(11, 40, seed=1, image_size=8)
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=7)
    t = tloader.DataLoader(t_ds, batch, **kw)
    j = jloader.DataLoader(j_ds, batch, **kw)
    s = tloader.DataLoader(t_ds, batch, sync=True, **kw)
    assert len(t) == len(j)
    for _ in range(2):
        got, want, inline = list(t), list(j), list(s)
        assert len(got) == len(want) == len(inline) == len(t)
        for g, w, i in zip(got, want, inline):
            assert_batches_equal(g, w)
            assert_batches_equal(i, w)
    sizes = [len(b["text_len"]) for b in got]
    assert sizes[-1] == (batch if drop_last or 11 % batch == 0
                         else 11 % batch)


@pytest.mark.parametrize("eval_type", ["image", "text"])
def test_data_module_matches_jax(saycam_dir, eval_type):
    """setup() on a SAYCam-format directory: the same vocab, splits,
    lengths and items (multiple_frames on the train split only), and the
    same eval-trial datasets per split."""
    kw = dict(dataset="saycam", data_dir=str(saycam_dir),
              multiple_frames=True, eval_type=eval_type,
              eval_include_sos_eos=True)
    t = tmodules.DataModule(tcfg.DataConfig(**kw), seed=2).setup()
    j = jmodules.DataModule(jcfg.DataConfig(**kw), seed=2).setup()
    assert t.vocab.word2idx == j.vocab.word2idx
    assert t.vocab_size == j.vocab_size == 4 + len(WORDS)
    assert sorted(t.datasets) == sorted(j.datasets) == [
        "test", "train", "val"]
    for split in t.datasets:
        td, jd = t.datasets[split], j.datasets[split]
        assert type(td).__name__ == type(jd).__name__
        assert td.multiple_frames == jd.multiple_frames == (
            split == "train")
        for i in range(len(jd)):
            assert_items_equal(td[i], jd[i])
    assert sorted(t.eval_datasets) == sorted(j.eval_datasets) == [
        "test", "val"]
    for split in t.eval_datasets:
        td, jd = t.eval_datasets[split], j.eval_datasets[split]
        assert type(td).__name__ == type(jd).__name__
        for i in range(len(jd)):
            assert_items_equal(td[i], jd[i])


def test_synthetic_module_matches_jax():
    kw = dict(dataset="synthetic", synthetic_size=16)
    t = tmodules.DataModule(tcfg.DataConfig(**kw), vocab_size_hint=50,
                            seed=4).setup()
    j = jmodules.DataModule(jcfg.DataConfig(**kw), vocab_size_hint=50,
                            seed=4).setup()
    assert t.vocab.word2idx == j.vocab.word2idx
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(t.datasets[split].text,
                                      j.datasets[split].text)
        assert len(t.datasets[split]) == len(j.datasets[split])
    assert t.eval_datasets == j.eval_datasets == {}


def test_prepare_data_refusals(tmp_path, monkeypatch):
    """Nothing to do without raw inputs; raw inputs run the ETL (an empty
    transcript directory gives empty splits) and COCO prepares nothing
    without its dataset_coco.json. The one refusal left is the ETL's
    default eval-frame scorer, the CLIP ViT-B/16 baseline, where neither a
    local directory nor the Hugging Face cache holds its weights (the port
    does not download)."""
    from multimodal_baby_tpu_torch.data import etl as tetl
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    cfg = tcfg.DataConfig(dataset="saycam", data_dir=str(tmp_path / "d"))
    assert tmodules.DataModule(cfg).prepare_data() is not None
    assert not (tmp_path / "d").exists()
    (tmp_path / "transcripts").mkdir()
    cfg.transcript_dir = str(tmp_path / "transcripts")
    tmodules.DataModule(cfg).prepare_data()
    assert json.loads((tmp_path / "d" / "train.json").read_text()) == {
        "data": []}
    coco = tcfg.DataConfig(dataset="coco", data_dir=str(tmp_path / "c"))
    tmodules.DataModule(coco).prepare_data()
    assert not (tmp_path / "c").exists()
    (tmp_path / "labeled" / "ball").mkdir(parents=True)
    with pytest.raises(FileNotFoundError,
                       match="clip-vit-base-patch16.*does not download"):
        tetl.filter_eval_frames(tmp_path / "labeled", tmp_path / "f",
                                device="cpu")
