"""The port's data- and vocab-parallel training (``parallel/``,
``train/step.py``, the trainer) across gloo processes on the CPU, against
the JAX package's mesh results on the 8-virtual-device CPU mesh
(``tests/conftest.py``) from the same weights.

One spawn of 4 ranks runs every loss layout (``tests/
torch_parallel_worker.py``: the ranks import nothing of JAX), one of 2
ranks the trainer; the module-scoped fixtures return every rank's results
and the tests assert them:

- (4, 1), global negatives: loss, the four diagnostics and every head's
  gradient against the JAX mesh step's within rtol 1e-5
  (``tests/test_train_step.py:53``); one AdamW step's parameters equal on
  every rank and the world-1 step's;
- (4, 1), per-shard negatives: the JAX mesh's loss and diagnostics, the
  loss the mean of the per-shard InfoNCE, the entropies logged (:78, :199);
- a ragged tail, 13 rows on 4 ranks padded to 16: the unpadded values
  exactly (rtol 1e-5, :168);
- (2, 2), the vocab-sharded embedding and tied LM head at lambda_lm 0.5:
  loss and embedding gradient against the JAX (2, 2) mesh
  (``tests/test_tensor_parallel.py:20``); (1, 4) with a vocab of 61 (the
  last rank's slice padded) against the JAX package on one device;
- the trainer at world 2, (2, 1) and (1, 2) with the LM head and text
  generation: the epochs' losses equal world 1's, every rank logs the same
  records, a checkpoint written at (2, 1) resumes at (1, 1) to the
  uninterrupted run's losses, and one written at (1, 2) holds the whole
  vocab.

Tolerances: losses and diagnostics rtol 1e-5; a gradient tensor's largest
difference within 1e-5 of its largest value.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.core import config as jcfg
from multimodal_baby_tpu.models import CVCL as JCVCL
from multimodal_baby_tpu.models.losses import contrastive_loss_from_logits
from multimodal_baby_tpu.parallel import (
    create_mesh as jcreate_mesh, make_param_shardings as jshardings,
    shard_batch as jshard_batch)
from multimodal_baby_tpu.train import make_loss_fn as jmake_loss_fn
from multimodal_baby_tpu_torch.api.convert import (
    cvcl_state_dict, load_state_dict)
from multimodal_baby_tpu_torch.core import config as tcfg
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.parallel import (
    create_mesh, local_rows, make_param_shardings, padded_rows, shard_batch)
from multimodal_baby_tpu_torch.train.step import (
    device_batch, init_train_state, make_train_step)
from multimodal_baby_tpu_torch.train.trainer import Trainer
from tests import torch_parallel_worker as worker

RTOL = 1e-5
DIAGNOSTICS = ("image_accuracy", "text_accuracy", "image_entropy",
               "text_entropy")


def make_cfg(vocab=64, **train_kw):
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(
            embedding_dim=32, vocab_size=vocab, embedding_type="flat",
            fix_temperature=False, normalize_features=True,
            vision=jcfg.VisionConfig(cnn_model="toy"),
            text=jcfg.TextConfig(text_encoder="lstm")),
        train=jcfg.TrainConfig(lr=1e-3, **train_kw),
        parallel=jcfg.ParallelConfig(compute_dtype="float32"))


def make_batch(seed, b=16, vocab=64, img=64):
    rng = np.random.RandomState(seed)
    text = np.zeros((b, 10), np.int32)
    text_len = rng.randint(2, 10, b).astype(np.int32)
    for i, n in enumerate(text_len):
        text[i, :n] = rng.randint(4, vocab, n)
    return {"image": rng.randn(b, img, img, 3).astype(np.float32),
            "text": text, "text_len": text_len}


def rel_diff(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


_INITS = {}


def jax_params(cfg, batch):
    """The JAX model and its initial parameters (one init per vocab)."""
    model = JCVCL(cfg.model)
    if cfg.model.vocab_size not in _INITS:
        b = jax.tree_util.tree_map(jnp.asarray, batch)
        _INITS[cfg.model.vocab_size] = model.init(
            jax.random.PRNGKey(0), b["image"], b["text"],
            b["text_len"])["params"]
    return model, _INITS[cfg.model.vocab_size]


class Case:
    """A JAX model's weights, a batch, and the JAX package's loss,
    metrics and gradients (port names) on ``mesh_shape`` (None: one
    device), over the first devices of the virtual mesh."""

    def __init__(self, cfg, batch, mesh_shape, pad_to=None, per_shard=False):
        cfg.parallel.global_batch_negatives = not per_shard
        self.cfg, self.batch, self.pad_to = cfg, batch, pad_to
        self.mesh_shape = mesh_shape
        self.model, self.params = jax_params(cfg, batch)
        self.state = cvcl_state_dict(jax.tree.map(np.asarray, self.params),
                                     {})

    def run(self):
        """The JAX package's loss, metrics and gradients."""
        cfg, batch, pad_to = self.cfg, self.batch, self.pad_to
        model, params, mesh_shape = self.model, self.params, self.mesh_shape
        rng = jax.random.PRNGKey(1)
        mesh = None
        if mesh_shape is not None:
            d, m = mesh_shape
            mesh = jcreate_mesh(mesh_shape, devices=jax.devices()[:d * m])
        loss_fn = jmake_loss_fn(model, cfg, mesh)
        fn = jax.jit(jax.value_and_grad(
            lambda p, x: loss_fn(p, {}, x, rng, False), has_aux=True))
        if mesh is None:
            (loss, (metrics, _)), grads = fn(
                params, jax.tree_util.tree_map(jnp.asarray, batch))
        else:
            if mesh_shape[1] > 1:
                params = jax.tree_util.tree_map(
                    jax.device_put, params, jshardings(mesh, params))
            with mesh:
                (loss, (metrics, _)), grads = fn(
                    params, jshard_batch(mesh, batch, pad_to=pad_to))
        self.loss = float(loss)
        self.metrics = {k: float(v) for k, v in metrics.items()}
        self.grads = cvcl_state_dict(
            jax.tree.map(lambda x: np.asarray(x), jax.device_get(grads)), {})

    def job(self, mesh_shape):
        return ("loss", dict(cfg_json=self.cfg.to_json(), state=self.state,
                             batch=self.batch, mesh_shape=mesh_shape,
                             pad_to=self.pad_to))


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    cases = {
        "global": (Case(make_cfg(), make_batch(0), (4, 1)), (4, 1)),
        "per_shard": (Case(make_cfg(), make_batch(1), (4, 1),
                           per_shard=True), (4, 1)),
        "ragged": (Case(make_cfg(), make_batch(7, b=13), (4, 1), pad_to=16),
                   (4, 1)),
        "ragged_per_shard": (Case(make_cfg(), make_batch(8, b=13), (4, 1),
                                  pad_to=16, per_shard=True), (4, 1)),
        "vocab": (Case(make_cfg(lambda_lm=0.5), make_batch(3), (2, 2)),
                  (2, 2)),
        "vocab_padded": (Case(make_cfg(vocab=61, lambda_lm=0.5),
                              make_batch(4, vocab=61), None), (1, 4)),
    }
    jobs = {name: case.job(shape) for name, (case, shape) in cases.items()}
    # the ranks run while the JAX package computes its side
    ranks = worker.spawn(4, jobs, tmp_path_factory.mktemp("gloo4"))
    for case, _ in cases.values():
        case.run()
    ranks = ranks.results()
    return {name: (case, [r[name] for r in ranks])
            for name, (case, _) in cases.items()}


def assert_loss_and_metrics(case, ranks, keys=DIAGNOSTICS):
    for r in ranks:  # the same, replicated values on every rank
        assert r["loss"] == ranks[0]["loss"]
        assert r["metrics"] == ranks[0]["metrics"]
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], case.loss, rtol=RTOL)
    for k in keys:
        np.testing.assert_allclose(got["metrics"][k], case.metrics[k],
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def assert_grads(case, ranks, names=None):
    for r in ranks[1:]:
        for k, v in r["grads"].items():
            np.testing.assert_array_equal(v, ranks[0]["grads"][k])
    got = ranks[0]["grads"]
    names = names or sorted(got)
    assert set(names) <= set(case.grads)
    for k in names:
        assert got[k].shape == case.grads[k].shape, k
        assert rel_diff(got[k], case.grads[k]) <= RTOL, (
            k, rel_diff(got[k], case.grads[k]))


def port_step(case):
    """The world-1 port's AdamW step on the whole batch: its trainable
    parameters and their gradients."""
    cfg = tcfg.ExperimentConfig.from_json(case.cfg.to_json())
    model = CVCL(cfg.model, device="cpu")
    load_state_dict(model, case.state)
    state = init_train_state(model, cfg)
    make_train_step(model, cfg)(state, device_batch(case.batch, "cpu"))
    return {n: (p.detach().numpy(), p.grad.numpy())
            for n, p in model.named_parameters() if p.requires_grad}


def test_global_negatives_match_jax_mesh(losses):
    """(4, 1): 4 rows a rank, the 16 x 16 InfoNCE over gathered features:
    loss, diagnostics and gradients (the vision head, the LSTM, the token
    embedding, the temperature) as the JAX package's mesh step."""
    case, ranks = losses["global"]
    assert [r["rows"] for r in ranks] == [4] * 4
    assert_loss_and_metrics(case, ranks)
    assert ranks[0]["metrics"]["batch_size"] == 16.0
    assert_grads(case, ranks, ["vision_encoder.model.fc.weight",
                               "vision_encoder.model.fc.bias",
                               "text_encoder.embedding.weight",
                               "text_encoder.lstm.weight_ih_l0",
                               "text_encoder.lstm.weight_hh_l0",
                               "model.logit_neg_log_temperature"])


def test_train_step_equals_world_one(losses):
    """One AdamW step: every rank's parameters bit-equal to each other's
    and, where a gradient is not vanishing (AdamW's first step moves an
    element by about lr * sign(g)), within 1e-5 of the world-1 step's."""
    case, ranks = losses["global"]
    want = port_step(case)
    assert sorted(ranks[0]["trained"]) == sorted(want)
    for r in ranks[1:]:
        for k, v in r["trained"].items():
            np.testing.assert_array_equal(v, ranks[0]["trained"][k])
    for k, (p, g) in want.items():
        moved = np.abs(g) >= 1e-6
        got = ranks[0]["trained"][k]
        np.testing.assert_allclose(got[moved], p[moved], rtol=0,
                                   atol=1e-5 * max(np.abs(p).max(), 1e-3),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["per_shard", "ragged_per_shard"])
def test_per_shard_negatives(losses, name):
    """Each rank's 4 x 4 block: the JAX mesh's loss and pooled
    diagnostics, the loss the valid-weighted mean of the blocks' InfoNCE
    (the plain mean without padding), the entropies logged."""
    case, ranks = losses[name]
    assert_loss_and_metrics(case, ranks)
    assert ranks[0]["metrics"]["image_entropy"] > 0.0
    assert ranks[0]["metrics"]["text_entropy"] > 0.0
    if name == "per_shard":
        # the mean of per-block InfoNCE on the one-device logits
        b = jax.tree_util.tree_map(jnp.asarray, case.batch)
        out = jax.jit(lambda p: case.model.apply(
            {"params": p}, b["image"], b["text"], b["text_len"],
            method="joint_forward"))(case.params)
        lpi = np.asarray(out["logits_per_image"])
        want = np.mean([float(contrastive_loss_from_logits(
            jnp.asarray(lpi[i * 4:(i + 1) * 4, i * 4:(i + 1) * 4]),
            jnp.asarray(lpi[i * 4:(i + 1) * 4, i * 4:(i + 1) * 4].T))[0])
            for i in range(4)])
        np.testing.assert_allclose(ranks[0]["loss"], want, rtol=RTOL)
    assert_grads(case, ranks, ["vision_encoder.model.fc.weight",
                               "text_encoder.embedding.weight"])


def test_ragged_tail_pads_and_masks_exactly(losses):
    """13 rows on 4 ranks: padded to 16 with wrap-around rows (ranks 0-2
    all real, rank 3 one real row), the loss, diagnostics and gradients
    those of the unpadded batch; batch_size 13."""
    case, ranks = losses["ragged"]
    assert [r["rows"] for r in ranks] == [4] * 4
    assert ranks[0]["metrics"]["batch_size"] == 13.0
    assert_loss_and_metrics(case, ranks)
    assert_grads(case, ranks, ["vision_encoder.model.fc.weight",
                               "text_encoder.embedding.weight",
                               "model.logit_neg_log_temperature"])
    # the port on one device, unpadded
    cfg = tcfg.ExperimentConfig.from_json(case.cfg.to_json())
    model = CVCL(cfg.model, device="cpu")
    load_state_dict(model, case.state)
    from multimodal_baby_tpu_torch.train.step import make_loss_fn
    with torch.no_grad():
        loss, metrics = make_loss_fn(model, cfg)(
            device_batch(case.batch, "cpu"), False)
    np.testing.assert_allclose(ranks[0]["loss"], float(loss), rtol=RTOL)
    for k in DIAGNOSTICS:
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(metrics[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["vocab", "vocab_padded"])
def test_vocab_sharded_lm_head(losses, name):
    """The vocab-sharded embedding and tied LM head at lambda_lm 0.5:
    (2, 2) against the JAX (2, 2) mesh, (1, 4) with 61 words (16 rows a
    rank, 3 padded) against the JAX package on one device: the loss, the
    LM's token means, the embedding's gradient (gathered whole) and the LM
    bias's."""
    case, ranks = losses[name]
    assert_loss_and_metrics(case, ranks, DIAGNOSTICS + (
        "ce_loss", "ce_loss_wo_sos", "n_tokens"))
    assert ranks[0]["grads"]["text_encoder.embedding.weight"].shape == (
        case.cfg.model.vocab_size, 32)
    assert_grads(case, ranks, ["text_encoder.embedding.weight",
                               "language_model.output_layer.bias",
                               "text_encoder.lstm.weight_ih_l0",
                               "vision_encoder.model.fc.weight"])


def test_mesh_helpers():
    """The mesh of one process, the JAX package's messages, the padded
    row order and each rank's rows, and the vocab-sharded parameters."""
    mesh = create_mesh((-1, 1))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") \
        is None
    for shape, msg in (((-1, -1), "at most one"), ((2, 1), "does not cover")):
        with pytest.raises(ValueError, match=msg):
            create_mesh(shape)
    np.testing.assert_array_equal(padded_rows(13, 4, 16),
                                  np.r_[np.arange(13), 0, 1, 2])
    np.testing.assert_array_equal(padded_rows(13, 4, 15),
                                  np.r_[np.arange(13), 0, 1, 2])
    np.testing.assert_array_equal(padded_rows(12, 4), np.arange(12))
    from multimodal_baby_tpu_torch.parallel.mesh import Mesh
    rows, valid = local_rows(Mesh(4, 2, rank=7), 13, 16)
    np.testing.assert_array_equal(rows, [12, 0, 1, 2])
    assert valid.tolist() == [True, False, False, False]
    got = shard_batch(Mesh(4, 1, rank=1), {"a": np.arange(13),
                                           "raw": list("abcdefghijklm")}, 16)
    assert got["a"].tolist() == [4, 5, 6, 7] and got["raw"] == list("efgh")
    assert got["valid"].all()
    cfg = tcfg.ExperimentConfig.from_json(make_cfg(lambda_lm=0.5).to_json())
    model = CVCL(cfg.model, device="cpu")
    specs = make_param_shardings(Mesh(2, 2), model)
    assert [k for k, v in specs.items() if v] == [
        "text_encoder.embedding.weight"]
    assert not any(make_param_shardings(Mesh(4, 1), model).values())


# ---------------------------------------------------------------- trainer

def trainer_cfg(root, exp, mesh, lm=False, epochs=1, resume=None):
    cfg = tcfg.ExperimentConfig(
        exp_name=exp,
        model=tcfg.ModelConfig(
            embedding_dim=16, vocab_size=61, normalize_features=True,
            vision=tcfg.VisionConfig(cnn_model="toy"),
            text=tcfg.TextConfig(text_encoder="lstm" if lm
                                 else "embedding")),
        data=tcfg.DataConfig(dataset="synthetic", synthetic_size=35,
                             batch_size=16, val_batch_size=16,
                             num_workers=2),
        train=tcfg.TrainConfig(
            lr=1e-3, max_epochs=epochs, log_every_n_steps=1,
            checkpoint_dir=str(root), resume_ckpt=resume,
            lambda_lm=0.5 if lm else 0.0, eval_textgen=lm, beam_width=2,
            decode_length=4),
        parallel=tcfg.ParallelConfig(mesh_shape=mesh,
                                     compute_dtype="float32"))
    return cfg


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    jobs = {"d2": ("trainer", dict(
                cfg_json=trainer_cfg(root, "d2", (2, 1)).to_json(),
                mesh_shape=(2, 1))),
            "m2": ("trainer", dict(
                cfg_json=trainer_cfg(root, "m2", (1, 2), lm=True).to_json(),
                mesh_shape=(1, 2)))}
    ranks = worker.spawn(2, jobs, root / "gloo2")
    one = {}
    for exp, lm in (("d2", False), ("m2", True)):
        tr = Trainer(trainer_cfg(root / "one", exp, (1, 1), lm=lm),
                     device="cpu")
        tr.fit()
        one[exp] = tr
    full = Trainer(trainer_cfg(root / "full", "d2", (1, 1), epochs=2),
                   device="cpu")
    full.fit()
    ranks = ranks.results()
    resumed = Trainer(trainer_cfg(root, "d2", (1, 1), epochs=2,
                                  resume="last"), device="cpu")
    start = resumed.start_epoch
    resumed.fit()
    return {"root": root, "ranks": ranks, "one": one, "full": full,
            "resumed": resumed, "start": start}


def records(path, key):
    return [r[key] for r in map(json.loads, path.read_text().splitlines())
            if key in r]


@pytest.mark.parametrize("exp", ["d2", "m2"])
def test_trainer_world_two_equals_world_one(trainers, exp):
    """One epoch of 35 synthetic pairs at B = 16 (the tail of 3 padded to
    16 at (2, 1)): the logged train and val losses equal world 1's within
    rtol 1e-5; every rank logs the same records, rank 1 to its own file;
    text generation's scores (run on rank 0 with the whole vocab) reach
    every rank."""
    ranks = trainers["ranks"]
    logs = [r[exp]["log"] for r in ranks]
    assert logs == ["metrics.jsonl", "metrics.rank1.jsonl"]
    strip = [[{k: v for k, v in rec.items() if k != "time"}
              for rec in r[exp]["records"]] for r in ranks]
    assert strip[0] == strip[1]
    one = trainers["one"][exp].logger.path
    for key in ("train_loss", "val_loss"):
        got = [r[key] for r in strip[0] if key in r]
        want = records(one, key)
        assert len(got) == len(want) > 0, key
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=key)
    if exp == "m2":
        assert "val_Bleu_1" in strip[0][-1] or any(
            "val_Bleu_1" in r for r in strip[0])


def test_checkpoint_resumes_across_mesh_shapes(trainers):
    """The (2, 1) run's checkpoint, resumed at (1, 1), starts at epoch 1
    and step 3 and gives the second epoch's losses of an uninterrupted
    world-1 run; the (1, 2) run's checkpoint holds the whole vocab (61
    rows) and its AdamW moments, equal to world 1's."""
    root = trainers["root"]
    assert trainers["start"] == 1
    assert trainers["resumed"].state.step == trainers["full"].state.step == 6
    got = records(root / "d2" / "metrics.jsonl", "train_loss")[3:]
    want = records(root / "full" / "d2" / "metrics.jsonl", "train_loss")[3:]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=RTOL)
    saved = torch.load(root / "m2" / "last" / "state.pt", weights_only=True)
    one = torch.load(root / "one" / "m2" / "last" / "state.pt",
                     weights_only=True)
    assert saved["model"].keys() == one["model"].keys()
    emb = "text_encoder.embedding.weight"
    assert saved["model"][emb].shape == (61, 16)
    for k, v in one["model"].items():
        assert rel_diff(saved["model"][k], v) <= 1e-4, k
    for i, st in one["optimizer"]["state"].items():
        for n, v in st.items():
            assert saved["optimizer"]["state"][i][n].shape == v.shape, (i, n)
    state = trainers["ranks"][0]["m2"]["state"]
    np.testing.assert_array_equal(state[emb], saved["model"][emb].numpy())
