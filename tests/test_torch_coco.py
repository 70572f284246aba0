"""The port's COCO captions module (``data/coco.py``) against the JAX
package's: ``prepare_coco``'s files byte for byte, the vocab threshold and
its id order, the dataset items (the random caption draws included), and
the port's ``DataModule`` on a COCO directory.

The Karpathy-format JSON is drawn from a seed: 12 images (64 px JPEGs
under ``train2014/`` and ``val2014/``) of 3 captions each over a 9-word
list, in all four Karpathy splits (``restval`` joins train).
"""

import json

import numpy as np
import pytest
from PIL import Image

from multimodal_baby_tpu.data import coco as jcoco
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data import coco as tcoco
from multimodal_baby_tpu_torch.data import loader as tloader
from multimodal_baby_tpu_torch.data import modules as tmodules
from tests.test_torch_train_data import assert_items_equal
from tests.torch_jax_decoder import same_decoder

WORDS = ["a", "man", "dog", "rides", "runs", "park", "red", "ball", "on"]
SPLITS = ["train", "train", "val", "test", "restval", "train"]


def karpathy_json(root, rng, n=12, captions=3):
    images = []
    for i in range(n):
        sub = "train2014" if i % 2 == 0 else "val2014"
        (root / sub).mkdir(parents=True, exist_ok=True)
        fname = f"COCO_{sub}_{i:012d}.jpg"
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
            root / sub / fname, quality=90)
        sents = [{"tokens": list(rng.choice(WORDS, rng.randint(3, 9))),
                  "sentid": i * captions + j} for j in range(captions)]
        images.append({"filename": fname, "filepath": sub,
                       "split": SPLITS[i % len(SPLITS)],
                       "sentences": sents, "imgid": i})
    return {"images": images}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    blob = karpathy_json(root, np.random.RandomState(0))
    (root / "dataset_coco.json").write_text(json.dumps(blob))
    for name, mod in (("jax", jcoco), ("port", tcoco)):
        mod.prepare_coco(root / name, root / "dataset_coco.json",
                         count_threshold=2)
    return root, blob


def test_prepare_coco_byte_equal(coco):
    root, _ = coco
    for f in ("vocab.json", "train.json", "val.json", "test.json"):
        assert (root / "port" / f).read_bytes() == \
            (root / "jax" / f).read_bytes(), f
    train = json.loads((root / "port" / "train.json").read_text())
    assert len(train["images"]) == 8  # train and restval
    # idempotent: a prepared directory is left as it is
    stamp = (root / "port" / "train.json").stat().st_mtime_ns
    tcoco.prepare_coco(root / "port", root / "dataset_coco.json")
    assert (root / "port" / "train.json").stat().st_mtime_ns == stamp


@pytest.mark.parametrize("threshold", [0, 2, 5, 40])
def test_vocab_threshold_matches_jax(coco, threshold):
    """count > threshold, ids by (count, token) descending after the four
    special tokens."""
    _, blob = coco
    t = tcoco.build_coco_vocab(blob, threshold)
    j = jcoco.build_coco_vocab(blob, threshold)
    assert t.word2idx == j.word2idx
    assert list(t.word2idx)[:4] == ["<pad>", "<unk>", "<sos>", "<eos>"]


@pytest.mark.parametrize("multiple", [False, True])
def test_dataset_items_match_jax(coco, multiple, monkeypatch):
    """(image, ids, length, raw captions) item by item, twice over (the
    random caption draws go on alike), both sides on one decoder
    (``tests/torch_jax_decoder.py``)."""
    same_decoder(monkeypatch)
    root, _ = coco
    data = json.loads((root / "port" / "train.json").read_text())
    t = tcoco.COCOCaptionsDataset(data, root, multiple_captions=multiple,
                                  seed=4)
    j = jcoco.COCOCaptionsDataset(data, root, multiple_captions=multiple,
                                  seed=4)
    assert len(t) == len(j) == 8
    for _ in range(2):
        for i in range(len(j)):
            assert_items_equal(t[i], j[i])
    img, ids, length, raws = t[0]
    assert img.shape == (224, 224, 3) and ids[0] == 2 \
        and ids[length - 1] == 3 and len(raws) == 3


def test_data_module_coco(coco, tmp_path):
    """prepare_data prepares from dataset_coco.json (the published
    threshold, 5) and setup builds the three splits, the images found
    under data_dir; the loader collates them."""
    root, blob = coco
    data = tmp_path / "coco"
    data.mkdir()
    for sub in ("train2014", "val2014"):
        (data / sub).symlink_to(root / sub)
    (data / "dataset_coco.json").write_text(json.dumps(blob))
    cfg = tcfg.DataConfig(dataset="coco", data_dir=str(data))
    dm = tmodules.DataModule(cfg, seed=1).prepare_data().setup()
    jcoco.prepare_coco(tmp_path / "jax", data / "dataset_coco.json")
    assert (data / "vocab.json").read_bytes() == \
        (tmp_path / "jax" / "vocab.json").read_bytes()
    assert sorted(dm.datasets) == ["test", "train", "val"]
    assert [len(dm.datasets[s]) for s in ("train", "val", "test")] == [
        8, 2, 2]
    assert dm.eval_datasets == {} and dm.vocab_size == len(dm.vocab)
    batch = next(iter(tloader.DataLoader(dm.datasets["val"], 2,
                                         shuffle=False, sync=True)))
    assert batch["image_u8"].shape == (2, 224, 224, 3)
    assert [len(r) for r in batch["raw"]] == [3, 3]
