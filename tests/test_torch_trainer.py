"""The port's Trainer against the JAX package's, end to end on the CPU.

Both fit 2 epochs of synthetic pairs (32 train, 8 val; B = 16, which the
JAX trainer's 8 virtual devices split without padding) on the toy trunk in
f32, with the augment off, dropout 0 and the plateau schedule on
(patience 0, factor 0.5), from the same weights: the JAX trainer's
initial parameters carried into the port with ``cvcl_state_dict``. Then:
the per-step train losses, the val losses and the final trainable
parameters against the JAX run; the LR sequence of a continuation with a
constant val loss; the checkpoint layout and index; config.json across
the packages; the port's resume against an uninterrupted run; and
loading the port's checkpoint directories. The JAX fit runs once per
module. Tolerances are stated where they are used.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.train.trainer import Trainer as JTrainer
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.api.model import CVCLModel, load_model
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.train.trainer import Trainer

LOSS_RTOL = 1e-5    # per-step train and val losses
PARAM_ATOL = 1e-5   # final trainable parameters
EPOCHS = 2
CONTINUE_TO = 5     # the LR continuation: epochs 2-4 at a constant val loss


def make_cfg(ckpt_dir, **train_kw):
    return jcfg.ExperimentConfig(
        exp_name="t",
        model=jcfg.ModelConfig(
            embedding_dim=16, vocab_size=64, embedding_type="flat",
            normalize_features=True,
            vision=jcfg.VisionConfig(cnn_model="toy"),
            text=jcfg.TextConfig(text_encoder="embedding")),
        data=jcfg.DataConfig(dataset="synthetic", synthetic_size=32,
                             batch_size=16, val_batch_size=16,
                             num_workers=2),
        train=jcfg.TrainConfig(
            lr=1e-3, lr_scheduler=True, patience=0, factor=0.5,
            max_epochs=EPOCHS, log_every_n_steps=1,
            checkpoint_dir=str(ckpt_dir), **train_kw),
        parallel=jcfg.ParallelConfig(compute_dtype="float32"))


def port_cfg(cfg, **train_kw):
    out = tcfg.ExperimentConfig.from_json(cfg.to_json())
    for k, v in train_kw.items():
        setattr(out.train, k, v)
    return out


def log_records(path, key):
    return [r[key] for r in map(json.loads, path.read_text().splitlines())
            if key in r]


def record_lrs(trainer, lrs):
    """Append the plateau's LR after every validation."""
    step = trainer.plateau.step

    def spy(metric, lr):
        lrs.append(step(metric, lr))
        return lrs[-1]

    trainer.plateau.step = spy


def continue_at_constant_loss(trainer, lrs):
    """Epochs EPOCHS..CONTINUE_TO-1 with the val loss pinned to 1.0: the
    first improves on the best, the next two reduce the LR."""
    trainer.validate = lambda split="val": {"loss": 1.0}
    trainer.cfg.train.max_epochs = CONTINUE_TO
    trainer.start_epoch = EPOCHS
    trainer.fit()


def port_trainer(cfg, init):
    trainer = Trainer(cfg, device="cpu")
    load_state_dict(trainer.model, cvcl_state_dict(init, {}))
    return trainer


def trainable(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()
            if p.requires_grad}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    out = {"root": root}
    cfg = make_cfg(root / "jax")
    jtr = JTrainer(cfg)
    init = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
    out["jax_lrs"] = []
    record_lrs(jtr, out["jax_lrs"])
    jtr.fit()
    out["jax_params"] = cvcl_state_dict(
        jax.tree.map(np.asarray, jax.device_get(jtr.state.params)), {})
    jdir = root / "jax" / "t"
    out["jax_layout"] = sorted(p.name for p in jdir.iterdir())
    out["jax_index"] = json.loads((jdir / "index.json").read_text())
    out["jax_config"] = (jdir / "config.json").read_text()
    continue_at_constant_loss(jtr, out["jax_lrs"])

    # the port's 2-epoch fit from the JAX trainer's initial weights
    tr = port_trainer(port_cfg(make_cfg(root / "port")), init)
    out["port_lrs"] = []
    record_lrs(tr, out["port_lrs"])
    tr.fit()
    out["port_params"] = trainable(tr.model)
    out["port_steps"] = tr.state.step
    pdir = root / "port" / "t"
    out["port_layout"] = sorted(p.name for p in pdir.iterdir())
    out["port_files"] = sorted(str(p.relative_to(pdir))
                               for p in pdir.glob("*/*"))
    out["port_index"] = json.loads((pdir / "index.json").read_text())
    out["port_config"] = (pdir / "config.json").read_text()

    # resume it to 3 epochs, beside an uninterrupted 3-epoch run
    resumed = Trainer(port_cfg(make_cfg(root / "port"), resume_ckpt="last",
                               max_epochs=3), device="cpu")
    out["resumed_start"] = (resumed.start_epoch, resumed.state.step)
    resumed.fit()
    full = port_trainer(port_cfg(make_cfg(root / "full"), max_epochs=3),
                        init)
    full.fit()
    out["resumed"], out["full"] = resumed, full

    continue_at_constant_loss(tr, out["port_lrs"])
    out["jax_log"] = jdir / "metrics.jsonl"
    return out


def test_losses_match_jax(runs):
    """Per-step train losses (4) and val losses (2) of the 2-epoch fits
    within LOSS_RTOL (observed: at most 5.2e-7)."""
    port_log = runs["root"] / "port" / "t" / "metrics.jsonl"
    for key, n in (("train_loss", 2 * EPOCHS), ("val_loss", EPOCHS)):
        want = log_records(runs["jax_log"], key)[:n]
        got = log_records(port_log, key)[:n]
        assert len(got) == len(want) == n, key
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert runs["port_steps"] == 2 * EPOCHS


def test_final_parameters_match_jax(runs):
    """Every trainable parameter after 2 epochs within PARAM_ATOL
    (observed: at most 8.3e-7)."""
    got, want = runs["port_params"], runs["jax_params"]
    assert sorted(got) == ["language_model.output_layer.bias",
                           "model.logit_neg_log_temperature",
                           "text_encoder.embedding.weight",
                           "vision_encoder.model.fc.bias",
                           "vision_encoder.model.fc.weight"]
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_lr_sequence_matches_jax(runs):
    """The plateau's LR after each of the 5 epochs: equal at f32, the
    precision in which optax keeps the JAX LR; two reductions at the
    constant val loss."""
    got, want = runs["port_lrs"], runs["jax_lrs"]
    assert len(got) == len(want) == CONTINUE_TO
    assert np.float32(got).tolist() == np.float32(want).tolist()
    assert np.float32(got[-1]) == np.float32(got[-3] * 0.25)


def test_checkpoint_layout_matches_jax(runs):
    """The same names in the checkpoint directory and the same index (its
    val losses within LOSS_RTOL); each checkpoint a directory."""
    assert runs["port_layout"] == runs["jax_layout"]
    assert {"last", "index.json", "config.json", "vocab.json",
            "metrics.jsonl"} <= set(runs["port_layout"])
    got, want = runs["port_index"], runs["jax_index"]
    assert [(b["name"], b["epoch"]) for b in got["best"]] == \
        [(b["name"], b["epoch"]) for b in want["best"]]
    assert got["last"]["epoch"] == want["last"]["epoch"] == EPOCHS - 1
    assert got["last"]["extra"] == want["last"]["extra"] == {}
    np.testing.assert_allclose(
        [b["val_loss"] for b in got["best"]] + [got["last"]["val_loss"]],
        [b["val_loss"] for b in want["best"]] + [want["last"]["val_loss"]],
        rtol=LOSS_RTOL)
    assert runs["port_files"] == sorted(
        f"{name}/state.pt" for name in ["last"] + [b["name"]
                                                    for b in got["best"]])


def test_config_json_loads_in_both_packages(runs):
    j, t = runs["jax_config"], runs["port_config"]
    assert tcfg.ExperimentConfig.from_json(j).to_json() == j
    assert jcfg.ExperimentConfig.from_json(t).to_json() == t
    assert t.replace("/port", "/jax") == j


def test_resume_equals_uninterrupted_run(runs):
    """Resumed at epoch 2 and step 4, the port's third epoch gives the
    same weights, optimizer state, generator state and logged losses as
    an uninterrupted 3-epoch run, bit for bit."""
    resumed, full = runs["resumed"], runs["full"]
    assert runs["resumed_start"] == (2, 2 * EPOCHS)
    assert resumed.state.step == full.state.step == 6  # 3 epochs of 2
    for (k, a), (k2, b) in zip(resumed.model.state_dict().items(),
                               full.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa = resumed.state.optimizer.state_dict()
    sb = full.state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["state"][i][name]), (i, name)
    assert torch.equal(resumed.state.generator.get_state(),
                       full.state.generator.get_state())
    assert resumed.plateau.state_dict() == full.plateau.state_dict()
    logs = [log_records(runs["root"] / d / "t" / "metrics.jsonl",
                        "train_loss") for d in ("port", "full")]
    assert logs[0][2 * EPOCHS:2 * EPOCHS + 2] == logs[1][-2:]


def test_from_checkpoint_dir(runs):
    """load_model(dir) gives the trained model's image features bit for
    bit ("last"); "best" loads the best epoch's weights."""
    full = runs["full"]
    ckdir = runs["root"] / "full" / "t"
    images = np.random.RandomState(0).randn(3, 224, 224, 3).astype(
        np.float32)
    api, _ = load_model(str(ckdir), device="cpu")
    last = CVCLModel.from_checkpoint_dir(ckdir, which="last", device="cpu")
    with torch.no_grad():
        want = full.model.encode_image(torch.from_numpy(images))[0]
    assert torch.equal(last.encode_image(images), want)
    assert api.vocab.word2idx == full.data.vocab.word2idx
    best = json.loads((ckdir / "index.json").read_text())["best"][0]
    saved = torch.load(ckdir / best["name"] / "state.pt",
                       weights_only=True)["model"]
    for k, v in api.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    tokens, lens = api.tokenize(["w5 w6", "w7"])
    assert tuple(api.encode_text(tokens, lens).shape) == (2, 16)


def test_checkpoint_dir_refusals(runs, tmp_path):
    """A vocab_size no word table matches refuses, as in the JAX package,
    unless a placeholder vocab is asked for; an orbax directory (the JAX
    trainer's) refuses with a message."""
    ckdir = tmp_path / "t"
    shutil.copytree(runs["root"] / "full" / "t", ckdir)
    blob = json.loads((ckdir / "config.json").read_text())
    blob["model"]["vocab_size"] = 999
    (ckdir / "config.json").write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="vocab_size"):
        CVCLModel.from_checkpoint_dir(ckdir, device="cpu")
    blob["model"]["vocab_size"] = 64
    (ckdir / "vocab.json").unlink()
    (ckdir / "config.json").write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="vocab_size"):
        CVCLModel.from_checkpoint_dir(ckdir, device="cpu")
    m = CVCLModel.from_checkpoint_dir(ckdir, allow_placeholder_vocab=True,
                                      device="cpu")
    assert len(m.vocab) == 64 and m.vocab["<w0>"] == 4
    with pytest.raises(ValueError, match="orbax"):
        CVCLModel.from_checkpoint_dir(runs["root"] / "jax" / "t",
                                      device="cpu")
