"""The port's text-generation evaluation against the JAX package's.

- The Porter stemmer (``evaluation/porter.py``) equal to nltk's
  ``PorterStemmer()`` word for word over the packaged vocabulary, the
  scorers' test corpora and a seeded set of generated words.
- The three scorers' copies (``textgen_metrics``, ``meteor``, ``spice``)
  give exactly the JAX package's floats on the corpora of
  tests/test_textgen_metrics.py, tests/test_textgen_oracles.py and
  tests/test_spice_fixture.py and on a seeded corpus of packaged-vocabulary
  words, with and without a paraphrase table.
- ``run_textgen_eval``, unconditioned and captioning, on a toy-trunk LSTM
  model (vocab 32, E = H = 16) with the JAX package's weights moved
  through ``api/convert.py``: the sequences token for token and the scores
  within 1e-5.
- The trainer's validation with ``eval_textgen`` after one epoch of the
  joint recipe on synthetic pairs, both trainers from the same weights: the
  hypotheses token for token and the logged scores within 1e-5.
"""

import ast
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.data.vocab import Vocab as JVocab
from multimodal_baby_tpu.evaluation import meteor as jmeteor
from multimodal_baby_tpu.evaluation import spice as jspice
from multimodal_baby_tpu.evaluation import textgen as jtextgen
from multimodal_baby_tpu.evaluation import textgen_metrics as jmetrics
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.train.trainer import Trainer as JTrainer
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.api.model import PACKAGED_VOCAB
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.data.vocab import Vocab
from multimodal_baby_tpu_torch.evaluation import meteor, spice, textgen
from multimodal_baby_tpu_torch.evaluation import textgen_metrics
from multimodal_baby_tpu_torch.evaluation.porter import stem
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train import trainer as ttrainer

TESTS = Path(__file__).parent
SCORE_ATOL = 1e-5
WORDS = ["<pad>", "<unk>", "<sos>", "<eos>", "ball", "cat", "dog", "car",
         "the", "a", "big", "red", "look", "at", "is", "on", "in", "baby",
         "mommy", "book", "shoe", "hat", "bird", "milk", "truck", "see",
         "you", "it", "go", "up", "down", "here"]
V, E, L, IMG = len(WORDS), 16, 10, 64


def _sentences(path):
    """The lowercase word sequences among a test file's string literals."""
    tree = ast.parse(Path(path).read_text())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and re.fullmatch(r"[a-z]+( [a-z]+)+", n.value)]


def _corpus(name):
    """(references, hypotheses) of a named corpus."""
    if name == "oracles":
        from tests.test_textgen_oracles import HYPS, REFS
        return REFS, HYPS
    if name == "spice_fixture":
        from tests.test_spice_fixture import FIXTURE
        caps = [c for c, _ in FIXTURE]
        # each caption against itself and its neighbour, hypotheses rotated
        refs = [[c, caps[(i + 1) % len(caps)]] for i, c in enumerate(caps)]
        return refs, caps[2:] + caps[:2]
    if name == "metrics":
        sents = _sentences(TESTS / "test_textgen_metrics.py")
        refs = [[s, sents[(i + 3) % len(sents)]] for i, s in enumerate(sents)]
        return refs, sents[1:] + sents[:1]
    rng = random.Random(11)  # the packaged vocabulary's words
    words = [w for w in json.loads(PACKAGED_VOCAB.read_text())
             if not w.startswith("<")]
    refs, hyps = [], []
    for _ in range(40):
        base = rng.sample(words, rng.randint(2, 9))
        refs.append([" ".join(base), " ".join(rng.sample(base, len(base)))])
        h = list(base)
        h[rng.randrange(len(h))] = rng.choice(words)
        hyps.append(" ".join(h))
    return refs, hyps


CORPORA = ["metrics", "oracles", "spice_fixture", "vocab"]


@pytest.mark.parametrize("source", ["vocab", "corpora", "generated"])
def test_porter_matches_nltk(source):
    from nltk.stem.porter import PorterStemmer as NltkPorter
    if source == "vocab":
        words = list(json.loads(PACKAGED_VOCAB.read_text()))
    elif source == "corpora":
        words = sorted({w for name in CORPORA for refs, hyps in
                        [_corpus(name)] for s in hyps + sum(refs, [])
                        for w in s.split()})
    else:  # the suffixes the rules turn on, on seeded stems
        rng = random.Random(3)
        words = ["".join(rng.choice("aeiouybcdfglmnrstz")
                         for _ in range(rng.randint(1, 9))) + rng.choice([
                             "", "ies", "ied", "eed", "ing", "ed", "alli",
                             "logi", "fulli", "ational", "ness", "ion",
                             "ll", "e", "y", "bli", "izer", "ement", "sses"])
                 for _ in range(20000)]
    theirs = NltkPorter()
    bad = [(w, stem(w), theirs.stem(w)) for w in words
           if stem(w) != theirs.stem(w)]
    assert len(words) > 100 and not bad


@pytest.fixture(params=[False, True], ids=["no_table", "paraphrase_table"])
def paraphrases(request, monkeypatch):
    """The paraphrase stage off, or on with the same table in both
    packages (the module state is restored afterwards)."""
    pairs = [(["the", "baby"], ["the", "infant"]), (["big"], ["large"]),
             (["look", "at"], ["see"]), (["ball"], ["toy"])]
    for mod in (jmeteor, meteor):
        table = mod.ParaphraseTable(pairs) if request.param else None
        monkeypatch.setattr(mod, "_PARAPHRASES", table)
        monkeypatch.setattr(mod, "_PARA_ENV_CHECKED", True)
    return request.param


@pytest.mark.parametrize("corpus", CORPORA)
def test_scorers_equal_jax(corpus, paraphrases):
    refs, hyps = _corpus(corpus)
    assert textgen_metrics.evaluate(refs, hyps) == \
        jmetrics.evaluate(refs, hyps)
    assert [meteor.sentence_meteor(r, h) for r, h in zip(refs, hyps)] == \
        [jmeteor.sentence_meteor(r, h) for r, h in zip(refs, hyps)]
    assert [spice.parse_tuples(h) for h in hyps] == \
        [jspice.parse_tuples(h) for h in hyps]


def test_ids_to_sentence_equals_jax():
    vocab, jvocab = Vocab(dict(zip(WORDS, range(V)))), \
        JVocab(dict(zip(WORDS, range(V))))
    for ids in ([2, 4, 5, 3, 0, 0], [2, 4, 3], [4, 5], [2, 3], [0, 0],
                [2, 4, 0, 5, 3], [3, 2, 4]):
        assert textgen.ids_to_sentence(ids, vocab) == \
            jtextgen.ids_to_sentence(ids, jvocab)


# -------------------------------------------------------- run_textgen_eval

def model_cfg(captioning):
    return jcfg.ModelConfig(
        embedding_dim=E, vocab_size=V, embedding_type="flat",
        normalize_features=True, fix_temperature=True,
        vision=jcfg.VisionConfig(cnn_model="toy"),
        text=jcfg.TextConfig(text_encoder="lstm", captioning=captioning))


def build_pair(captioning):
    """(JAX model, variables, port model) on the JAX package's weights, the
    LM bias drawn so that the decodes are not flat."""
    cfg = model_cfg(captioning)
    model = JCVCL(cfg)
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1,), jnp.int32),
        method="joint_forward", use_mm=True, use_lm=True)
    params = jax.tree.map(np.asarray, variables["params"])
    params["lm_bias"] = (0.5 * np.random.RandomState(1).randn(V)).astype(
        np.float32)
    port = CVCL(tcfg.ExperimentConfig.from_json(
        jcfg.ExperimentConfig(model=cfg).to_json()).model, device="cpu")
    load_state_dict(port, cvcl_state_dict(params, {}))
    return model, {"params": params}, port


def make_batches(seed=0, sizes=(5, 3)):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        text = np.zeros((b, L), np.int32)
        lens = rng.randint(3, L + 1, b).astype(np.int32)
        raw = []
        for i, n in enumerate(lens):
            words = rng.randint(4, V, n - 2)
            text[i, 0], text[i, 1:n - 1], text[i, n - 1] = 2, words, 3
            raw.append(" ".join(WORDS[w] for w in words))
        out.append({"text": text, "text_len": lens, "raw": raw,
                    "image_u8": rng.randint(0, 256, (b, IMG, IMG, 3),
                                            np.uint8)})
    return out


@pytest.mark.parametrize("captioning", [False, True],
                         ids=["unconditioned", "captioning"])
def test_run_textgen_eval_matches_jax(captioning):
    model, variables, port = build_pair(captioning)
    batches = make_batches()
    vocab, jvocab = Vocab(dict(zip(WORDS, range(V)))), \
        JVocab(dict(zip(WORDS, range(V))))
    kw = dict(beam_width=3, decode_length=8, length_penalty_alpha=0.6,
              captioning=captioning)
    j_scores, j_refs, j_hyps = jtextgen.run_textgen_eval(
        model, variables, batches, jvocab, **kw)
    scores, refs, hyps = textgen.run_textgen_eval(port, batches, vocab,
                                                  **kw)
    assert hyps == j_hyps and refs == j_refs
    assert all(hyps)
    # unconditioned, every row decodes the same sequence; conditioned, the
    # image changes it
    assert len(set(hyps)) == 1 if not captioning else len(set(hyps)) > 1
    assert sorted(scores) == sorted(j_scores)
    for k in scores:
        assert abs(scores[k] - j_scores[k]) <= SCORE_ATOL, k


# ---------------------------------------------------------------- trainer

def trainer_cfg(ckpt_dir):
    return jcfg.ExperimentConfig(
        exp_name="t",
        model=jcfg.ModelConfig(
            embedding_dim=16, vocab_size=64, embedding_type="flat",
            normalize_features=True,
            vision=jcfg.VisionConfig(cnn_model="toy"),
            text=jcfg.TextConfig(text_encoder="lstm")),
        data=jcfg.DataConfig(dataset="synthetic", synthetic_size=32,
                             batch_size=16, val_batch_size=16,
                             num_workers=2),
        train=jcfg.TrainConfig(
            lr=1e-3, max_epochs=1, lambda_mm=0.5, lambda_lm=0.5,
            optimize_unused=True, eval_textgen=True, beam_width=2,
            decode_length=6, log_every_n_steps=1,
            checkpoint_dir=str(ckpt_dir)),
        parallel=jcfg.ParallelConfig(compute_dtype="float32"))


def spy_textgen(monkeypatch, module, name, hyps):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        hyps.append(out[2])
        return out
    monkeypatch.setattr(module, name, spy)


def test_trainer_validation_textgen_matches_jax(tmp_path, monkeypatch):
    j_hyps, t_hyps = [], []
    spy_textgen(monkeypatch, jtextgen, "run_textgen_eval", j_hyps)
    spy_textgen(monkeypatch, ttrainer, "run_textgen_eval", t_hyps)
    cfg = trainer_cfg(tmp_path / "jax")
    jtr = JTrainer(cfg)
    init = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
    j_val = jtr.fit()

    pcfg = tcfg.ExperimentConfig.from_json(
        trainer_cfg(tmp_path / "port").to_json())
    tr = ttrainer.Trainer(pcfg, device="cpu")
    load_state_dict(tr.model, cvcl_state_dict(init, {}))
    t_val = tr.fit()
    assert len(j_hyps) == len(t_hyps) == 1 and len(t_hyps[0]) == 8
    assert t_hyps == j_hyps
    keys = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
            "CIDEr", "SPICE")
    for k in keys:
        assert abs(t_val[k] - j_val[k]) <= SCORE_ATOL, k
    logged = [json.loads(line) for line in
              (tmp_path / "port" / "t" / "metrics.jsonl").read_text()
              .splitlines()]
    val = [r for r in logged if "val_Bleu_1" in r]
    assert len(val) == 1 and all(f"val_{k}" in val[0] for k in keys)
