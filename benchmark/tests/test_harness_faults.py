"""A run with the timed path broken underneath comes out not correct, once
for each fault that a cell can have: a train step that returns its state
unchanged, half of the batch left out (the loss's mean over the rest),
and an answer altered where it is produced. The run is driven whole on
the CPU at a tiny size, past the harness's look for a card; the number
that the fault moves reads above its limit and above the sound run's."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

TRAIN = "resnext_train_b512"
EMBED = "resnext_embed_b256"


def _step_maker(fault):
    from multimodal_baby_tpu_torch.train.step import make_train_step

    def make(model, exp):
        real = make_train_step(model, exp)
        trained = [p for p in model.parameters() if p.requires_grad]

        def step(state, batch):
            if fault == "half_batch":
                half = batch["text"].shape[0] // 2
                return real(state, {k: v[:half] for k, v in batch.items()})
            saved = [p.detach().clone() for p in trained]
            out = real(state, batch)
            with torch.no_grad():
                for p, s in zip(trained, saved):
                    p.copy_(s)
            return out
        return step
    return make


@pytest.fixture(scope="module")
def sound():
    mp = pytest.MonkeyPatch()
    try:
        return {w: tiny.run_tiny(w, mp)["checks"] for w in (TRAIN, EMBED)}
    finally:
        mp.undo()


@pytest.mark.parametrize("fault,number", [("state_unchanged", "change_gap"),
                                          ("half_batch", "loss_gap")])
def test_train_faults_fail(fault, number, sound, monkeypatch):
    res = tiny.run_tiny(TRAIN, monkeypatch,
                        make_train_step=_step_maker(fault))
    got = res["checks"][number]["value"]
    assert not res["correct"]
    assert got > harness.limits(TRAIN)[number]
    assert got > 2 * sound[TRAIN][number]["value"]


def test_an_altered_answer_fails(sound, monkeypatch):
    from multimodal_baby_tpu_torch.evaluation.linear_probe import (
        extract_features)

    def altered(model, frames, batch_size):
        out = extract_features(model, frames, batch_size)
        out[0] = -out[0]
        return out

    res = tiny.run_tiny(EMBED, monkeypatch, extract_features=altered)
    got = res["checks"]["embed_gap"]["value"]
    assert not res["correct"]
    assert got > harness.limits(EMBED)["embed_gap"]
    assert got > 10 * sound[EMBED]["embed_gap"]["value"]
