"""The port's copies of the framework-free data modules against the JAX
package's: ``vocab.json`` byte for byte, ``Vocab``, the tokenizer on a
fixed sentence set (contractions, exceptions, punctuation runs, hyphens,
curly apostrophes, unknown words, truncation), the forced-choice datasets'
items on 224 px PNG frames, the image loader on a frame that needs a
resize (both packages decode with the native C++ decoder; PIL's bicubic
resize where it is not built), and the
object-categories stimulus prep and trial metadata.
"""

import filecmp
import json

import numpy as np
import pytest
from PIL import Image

from multimodal_baby_tpu.api.model import PACKAGED_VOCAB as J_VOCAB_PATH
from multimodal_baby_tpu.data import datasets as jds
from multimodal_baby_tpu.data import object_categories as joc
from multimodal_baby_tpu.data import tokenizer as jtok
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu_torch.api.model import PACKAGED_VOCAB
from multimodal_baby_tpu_torch.data import datasets as tds
from multimodal_baby_tpu_torch.data import object_categories as toc
from multimodal_baby_tpu_torch.data import tokenizer as ttok
from multimodal_baby_tpu_torch.data.vocab import Vocab
from tests.torch_jax_decoder import same_decoder

SENTENCES = [
    "ball", "a cat", "the kitty's ball!", "don't do that", "you're gonna "
    "fall", "c'mon let's go", "gotta go... now", "peek-a-boo", "'cause i "
    "said so", "it's five o'clock", "can't, cannot, won't", "what?! no!!",
    "i. o. s.", "look -- a dog", "you- the-- car", "(hello) [world] {x}",
    "zzzzunknownzzzz word", "lemme gimme", "she’s here, isn’t she", "",
    "one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty "
    "twenty-one twenty-two twenty-three twenty-four twenty-five"]


@pytest.fixture(scope="module")
def vocabs():
    return JVocab.load(J_VOCAB_PATH), Vocab.load(PACKAGED_VOCAB)


def test_packaged_vocab_is_a_byte_copy(vocabs):
    assert filecmp.cmp(J_VOCAB_PATH, PACKAGED_VOCAB, shallow=False)
    jv, tv = vocabs
    assert len(tv) == len(jv) == 2350
    assert tv.word2idx == jv.word2idx and tv.idx2word == jv.idx2word


def test_vocab_matches_jax(vocabs, tmp_path):
    jv, tv = vocabs
    words = ["ball", "cat", "zzzz", "<sos>", "kitty", "nope"]
    assert tv.to_ids(words) == jv.to_ids(words)
    assert tv.to_words([0, 1, 2, 3, 57]) == jv.to_words([0, 1, 2, 3, 57])
    assert [w in tv for w in words] == [w in jv for w in words]
    utterances = ["a b c a", "b a d", "a b", "c c c d e", "e e e"] * 2
    built = Vocab.build(utterances, min_freq=3)
    assert built.word2idx == JVocab.build(utterances, min_freq=3).word2idx
    built.save(tmp_path / "v.json")
    assert JVocab.load(tmp_path / "v.json").word2idx == built.word2idx


def test_tokenizer_matches_jax(vocabs):
    jv, tv = vocabs
    for s in SENTENCES:
        assert ttok.word_tokenize(s) == jtok.word_tokenize(s), s
    j_ids, j_lens = jtok.Tokenizer(jv)(SENTENCES)
    t_ids, t_lens = ttok.Tokenizer(tv)(SENTENCES)
    assert t_ids.dtype == j_ids.dtype and t_lens.dtype == j_lens.dtype
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_lens, j_lens)
    assert (t_lens == 25).any()  # the long sentence is truncated
    for s in SENTENCES[:6]:
        for got, want in zip(ttok.Tokenizer(tv).encode_utterance(s, 8),
                             jtok.Tokenizer(jv).encode_utterance(s, 8)):
            np.testing.assert_array_equal(got, want)


def write_trials(root, n=6, size=224):
    rng = np.random.RandomState(0)
    cats = ["ball", "cat", "dog", "car", "book"]
    trials = []
    for t in range(n):
        files = []
        for j in range(4):
            p = root / f"t{t}_{j}.png"
            Image.fromarray(rng.randint(0, 256, (size, size, 3),
                                        np.uint8)).save(p)
            files.append(str(p))
        target = cats[t % len(cats)]
        trials.append({"target_category": target,
                       "target_img_filename": files[0],
                       "foil_categories": [c for c in cats
                                           if c != target][:3],
                       "foil_img_filenames": files[1:]})
    path = root / "eval_filtered_dev.json"
    path.write_text(json.dumps({"data": trials}))
    return path


@pytest.mark.parametrize("sos", [False, True])
def test_eval_datasets_match_jax(vocabs, tmp_path, sos):
    jv, tv = vocabs
    path = write_trials(tmp_path)
    data = tds.load_metadata(path)
    assert data == jds.load_metadata(path)
    for jcls, tcls in ((jds.EvalTrialDataset, tds.EvalTrialDataset),
                       (jds.TextEvalTrialDataset, tds.TextEvalTrialDataset)):
        j, t = jcls(data, jv, sos), tcls(data, tv, sos)
        assert len(t) == len(j) == 6
        for i in range(len(t)):
            for got, want in zip(t[i], j[i]):
                np.testing.assert_array_equal(got, want)
    assert tds.EvalTrialDataset(data, tv).n_imgs() == 4


def test_image_loader_resizes_with_pil_bicubic(tmp_path, monkeypatch):
    """Where the native decoder is not built (or fails on a file), the
    loader decodes with PIL and resizes bicubic."""
    monkeypatch.setattr(tds.native, "decode_image", lambda *a, **k: None)
    arr = np.random.RandomState(1).randint(0, 256, (300, 200, 3), np.uint8)
    p = tmp_path / "big.png"
    Image.fromarray(arr).save(p)
    got = tds.load_image_uint8(str(p))
    want = np.asarray(Image.fromarray(arr).resize((224, 224),
                                                  Image.BICUBIC))
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_image_loader_matches_the_jax_loader(tmp_path, monkeypatch):
    """A frame that needs a resize: the port's loader decodes it as the
    JAX package's ``_load_image_uint8`` does (its native decoder, bilinear
    resize; PIL's bicubic on both sides where the JAX decoder cannot be
    built), byte for byte."""
    same_decoder(monkeypatch)
    arr = np.random.RandomState(1).randint(0, 256, (300, 200, 3), np.uint8)
    p = tmp_path / "big.png"
    Image.fromarray(arr).save(p)
    got = tds.load_image_uint8(str(p))
    want = jds._load_image_uint8(str(p))
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_object_categories_match_jax(vocabs, tmp_path):
    jv, tv = vocabs
    rng = np.random.RandomState(2)
    src = tmp_path / "stimuli"
    for cat in ("ball", "cat", "dog", "car", "notaword"):
        (src / cat).mkdir(parents=True)
        for k in range(3):
            Image.fromarray(rng.randint(0, 256, (64, 48, 3), np.uint8)).save(
                src / cat / f"{cat}_{k}.jpg")
    cats = toc.get_object_categories(src, tv)
    assert cats == joc.get_object_categories(src, jv) == ["ball", "car",
                                                          "cat", "dog"]
    toc.resize_object_images(src, tmp_path / "t", cats)
    joc.resize_object_images(src, tmp_path / "j", cats)
    for cat in cats:
        for k in range(3):
            name = f"{cat}/{cat}_{k}.jpg"
            got = np.asarray(Image.open(tmp_path / "t" / name))
            assert got.shape == (224, 224, 3)
            np.testing.assert_array_equal(
                got, np.asarray(Image.open(tmp_path / "j" / name)))
    n_t = toc.create_object_categories_metadata(
        tmp_path / "t", tmp_path / "t.json", tv, seed=3)
    n_j = joc.create_object_categories_metadata(
        tmp_path / "j", tmp_path / "j.json", jv, seed=3)
    assert n_t == n_j == 4 * 3 * 5
    t_trials = json.loads((tmp_path / "t.json").read_text())["data"]
    j_trials = json.loads((tmp_path / "j.json").read_text())["data"]
    for t, j in zip(t_trials, j_trials):
        t = dict(t, target_img_filename=t["target_img_filename"].replace(
            "/t/", "/j/"), foil_img_filenames=[
                f.replace("/t/", "/j/") for f in t["foil_img_filenames"]])
        assert t == j
