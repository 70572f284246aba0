"""The program's spans (``train/profiler.py``: ``span``, ``wait``,
``SPANS``): nothing recorded and one shared no-op context without a
profiler session; under a CPU ``torch.profiler`` session the trees of a
tiny CVCL's train step, ``device_batch`` and ``extract_features`` chunks,
each span among the profiler's events under the same name and nesting
with the same host duration; ``host_ms`` less the ``wait`` spans; a
store started afresh for each block and bounded; synchronizing calls
counted in the innermost span and the sync-debug mode, warning filters
and ``showwarning`` restored (the card's calls faked on the CPU). Marked
``gpu``: on the card, every synchronizing call on the benchmark cells'
paths falls inside a ``wait`` span."""

import json
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_baby_tpu_torch.core.config import ExperimentConfig
from multimodal_baby_tpu_torch.data import augment
from multimodal_baby_tpu_torch.evaluation.linear_probe import (
    extract_features)
from multimodal_baby_tpu_torch.models.multimodal import CVCL
from multimodal_baby_tpu_torch.train import profiler
from multimodal_baby_tpu_torch.train.profiler import (
    SYNC_WARNING, SpanStore, span, trace, wait)
from multimodal_baby_tpu_torch.train.step import (
    HostStaging, device_batch, init_train_state, make_train_step)

PX, B = 32, 4
CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"

AUGMENT = ("mmb/augment", [("mmb/wait/imagenet_mean", []),
                           ("mmb/wait/imagenet_std", [])])
VISION = ("mmb/vision", [("mmb/trunk", [])])
TAIL = [("mmb/loss", []), ("mmb/backward", []), ("mmb/optimizer", [])]
STEP = {"contrastive": [AUGMENT, VISION, ("mmb/text", []), ("mmb/loss", [])]
        + TAIL,
        "joint": [AUGMENT, VISION, ("mmb/text", []), ("mmb/loss", []),
                  ("mmb/lm", [])] + TAIL}
CHUNK = ("mmb/embed_chunk", [("mmb/h2d", [("mmb/wait/pageable_h2d", [])]),
                             ("mmb/wait/imagenet_mean", []),
                             ("mmb/wait/imagenet_std", []), VISION,
                             ("mmb/d2h", [("mmb/wait/d2h", [])])])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def store(monkeypatch):
    """A fresh store in the module's place."""
    s = SpanStore()
    monkeypatch.setattr(profiler, "SPANS", s)
    return s


def experiment(recipe, vision=None, text=None):
    """The benchmark's ResNeXt configuration (``recipe`` "contrastive"), or
    the joint LSTM recipe (InfoNCE and the LM at 0.5 each), with the toy
    trunk unless ``vision`` says otherwise."""
    d = json.loads((CONFIGS / "cvcl_resnext50.json").read_text())[
        "experiment"]
    d["model"]["vision"].update(vision or {"cnn_model": "toy"})
    d["model"]["text"].update(text or {})
    if recipe == "joint":
        d["model"]["text"]["text_encoder"] = "lstm"
        d["train"].update(lambda_mm=0.5, lambda_lm=0.5)
    if vision is None:
        d["model"].update(vocab_size=40, embedding_dim=16)
        d["parallel"]["compute_dtype"] = "float32"
    return ExperimentConfig.from_dict(d)


def host_batch(rng, n, px, vocab):
    lens = rng.randint(3, 25, n).astype(np.int32)
    text = np.zeros((n, 25), np.int32)
    for i, k in enumerate(lens):
        text[i, :k] = rng.randint(4, vocab, k)
    return {"image_u8": rng.randint(0, 256, (n, px, px, 3), np.uint8),
            "text": text, "text_len": lens}


def tiny(recipe):
    cfg = experiment(recipe)
    model = CVCL(cfg.model, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    return (model, init_train_state(model, cfg), make_train_step(model, cfg),
            host_batch(np.random.RandomState(0), B, PX, 40))


def trees(rows):
    """The roots' trees as (name, [children]) from ``SPANS.table()``."""
    kids = {i: [] for i in range(len(rows))}
    roots = []
    for i, r in enumerate(rows):
        (roots if r["parent"] is None else kids[r["parent"]]).append(i)

    def tree(i):
        return (rows[i]["name"], [tree(j) for j in kids[i]])
    return [tree(i) for i in roots]


def profiler_spans(prof):
    """The profiler's ``mmb/`` ranges in start order: (name, name of the
    nearest ``mmb/`` range above it or None, duration ms)."""
    out = []
    for e in sorted((e for e in prof.events() if e.name.startswith("mmb/")),
                    key=lambda e: e.time_range.start):
        up = e.cpu_parent
        while up is not None and not up.name.startswith("mmb/"):
            up = up.cpu_parent
        out.append((e.name, None if up is None else up.name,
                    e.time_range.elapsed_us() / 1e3))
    return out


def test_off_records_nothing_and_shares_one_context(store, monkeypatch):
    monkeypatch.setattr(augment.augment_batch, "__defaults__",
                        (PX,) + augment.augment_batch.__defaults__[1:])
    model, state, step, batch = tiny("contrastive")
    step(state, device_batch(batch, "cpu"))
    extract_features(model, batch["image_u8"], 2)
    assert store.spans == [] and store.stale
    assert span("a") is span("b") is wait("c")
    with span("a") as a:
        assert a is None


@pytest.mark.parametrize("recipe", sorted(STEP))
def test_the_paths_record_their_trees_on_the_profilers_clock(
        recipe, store, monkeypatch):
    monkeypatch.setattr(augment.augment_batch, "__defaults__",
                        (PX,) + augment.augment_batch.__defaults__[1:])
    model, state, step, batch = tiny(recipe)
    step(state, device_batch(batch, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(state, device_batch(batch, "cpu"))
        extract_features(model, batch["image_u8"], 2)
    rows = store.table()
    want = [("mmb/device_batch", []), ("mmb/train_step", STEP[recipe])] * 2
    assert trees(rows) == want + [CHUNK] * 2
    got = profiler_spans(prof)
    assert [(n, p) for n, p, _ in got] == [
        (r["name"], None if r["parent"] is None
         else rows[r["parent"]]["name"]) for r in rows]
    for (name, _, ms), r in zip(got, rows):
        # the span's clock reads lie inside the profiler's range
        assert r["host_ms"] <= ms + 0.05, name
        assert ms - r["host_ms"] <= 0.2 + 0.02 * ms, name
        assert r["device_ms"] == r["host_ms"] and r["syncs"] is None
    s = store.summary("mmb/train_step")
    assert s["steps"] == 2 and s["syncs"] is None
    assert store.summary("mmb/embed_chunk")["steps"] == 2
    assert store.summary("mmb/nothing") is None


def test_host_ms_leaves_out_the_waits(store):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with span("root"):
                with span("work"):
                    time.sleep(0.002)
                with wait("outer"):
                    time.sleep(0.02)
                    with wait("inner"):
                        time.sleep(0.01)
    s = store.summary("mmb/root")
    rows = store.table()
    root = sum(r["host_ms"] for r in rows if r["parent"] is None) / 2
    outer = sum(r["host_ms"] for r in rows
                if r["name"] == "mmb/wait/outer") / 2
    assert root >= 30 and s["waits"] == 2
    assert s["host_ms"] == pytest.approx(root - outer)
    assert 2 <= s["host_ms"] < 10
    assert s["self_ms"]["mmb/wait/outer"] == pytest.approx(
        s["device_ms"]["mmb/wait/outer"] - s["device_ms"]["mmb/wait/inner"])


def test_a_span_on_another_thread_nests_under_the_open_root(store):
    """Autograd runs a CUDA backward on its own device thread while the
    calling thread waits inside ``mmb/backward``: a span that thread opens
    is kept under the root thread's innermost open span. With no root
    open, a thread's span is a root of its own."""
    def worker():
        with span("vjp/mlp"):
            with span("inner"):
                pass

    def on_a_thread():
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()

    with profile(activities=[ProfilerActivity.CPU]):
        with span("root"):
            with span("backward"):
                on_a_thread()
            with span("after"):
                pass
        on_a_thread()
    vjp = ("mmb/vjp/mlp", [("mmb/inner", [])])
    assert trees(store.table()) == [
        ("mmb/root", [("mmb/backward", [vjp]), ("mmb/after", [])]), vjp]
    s = store.summary("mmb/root")
    assert s["steps"] == 1 and s["device_ms"]["mmb/vjp/mlp"] > 0


def test_each_block_starts_afresh(store, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            pass
    with span("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert [r["name"] for r in store.table()] == ["mmb/second"]
    with trace(str(tmp_path)):
        with span("third"):
            pass
    with trace(str(tmp_path)):
        with span("fourth"):
            pass
    assert [r["name"] for r in store.table()] == ["mmb/fourth"]
    assert "mmb/fourth" in (tmp_path / "trace.json").read_text()


def test_the_store_keeps_whole_roots_up_to_its_bound(monkeypatch):
    store = SpanStore(limit=5)
    monkeypatch.setattr(profiler, "SPANS", store)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c"):
            with span(name):
                with span("x"):
                    pass
                with span("y"):
                    pass
    assert trees(store.table()) == [("mmb/a", [("mmb/x", []),
                                               ("mmb/y", [])])]
    assert store.dropped_roots == 2
    assert store.summary("mmb/a")["steps"] == 1


class FakeEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_syncs_are_counted_and_the_warning_state_restored(store,
                                                          monkeypatch):
    """The card's calls faked: a root turns the sync-debug mode to "warn",
    counts each sync warning in the innermost span, passes other warnings
    on, and restores the mode, the filters and ``showwarning`` when it
    ends, also when it raises."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    stream = types.SimpleNamespace(device_index=0, cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 7,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    filters, show = list(warnings.filters), warnings.showwarning
    sync = SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp:1.)"
    with profile(activities=[ProfilerActivity.CPU]):
        with span("root"):
            assert modes == ["warn"] and warnings.showwarning is not show
            warnings.warn(sync)
            with wait("w"):
                warnings.warn(sync)
            with span("child"):
                warnings.warn(sync)
                warnings.warn(sync)
            warnings.warn("another warning")
        assert modes == ["warn", 0]
        assert warnings.showwarning is show and warnings.filters == filters
        with pytest.raises(RuntimeError):
            with span("root"):
                raise RuntimeError("inside a root")
    assert modes == ["warn", 0, "warn", 0]
    assert warnings.showwarning is show and warnings.filters == filters
    assert shown == ["another warning"]
    assert [r["syncs"] for r in store.table()] == [1, 1, 2, 0]
    s = store.summary("mmb/root")
    assert s["steps"] == 2
    assert s["waits"] == 0.5 and s["unwaited_syncs"] == 1.5
    assert s["syncs"] == 2.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["resnext_train", "vit_train",
                                  "resnext_embed"])
def test_every_sync_on_the_cells_paths_is_a_wait(cuda, cell, store):
    """The benchmark cells' calls at small batches (224 px frames, the
    configurations' widths, bf16): under a CUDA profiler session no
    synchronizing call falls outside a ``wait`` span, the known waits are
    there (the staging slot and the augment's two constants a train step;
    the pageable copy, the normalisation's two constants and the copy
    back a chunk), and no span's range reaches the device's timeline."""
    vision = {"cnn_model": "resnext50", "cnn_dino": True}
    text = {}
    if cell == "vit_train":
        vision = {"cnn_dino": False, "vit_dino": True}
        text = {"text_encoder": "transformer", "pos_embed_type": "learned"}
    cfg = experiment("contrastive", vision, text)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device=cuda,
                 generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    if cell == "resnext_embed":
        model.eval()
        frames = rng.randint(0, 256, (64, 224, 224, 3), np.uint8)
        extract_features(model, frames, 32)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            extract_features(model, frames, 32)
            torch.cuda.synchronize()
        s = store.summary("mmb/embed_chunk")
        assert s["steps"] == 2 and s["waits"] == 4
    else:
        state = init_train_state(model, cfg)
        step = make_train_step(model, cfg)
        staging = HostStaging()
        batches = [host_batch(rng, 8, 224, 2350) for _ in range(2)]
        for b in batches:
            step(state, device_batch(b, cuda, staging))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in batches:
                step(state, device_batch(b, cuda, staging))
            torch.cuda.synchronize()
        s = store.summary("mmb/train_step")
        assert s["steps"] == 2 and s["waits"] == 3
    assert s["unwaited_syncs"] == 0, store.table()
    assert s["syncs"] >= s["waits"]
    assert torch.cuda.get_sync_debug_mode() == 0
    assert s["device_ms"]["mmb/trunk"] > 0
    # the spans' ranges stay off the device's timeline
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and e.name().startswith("mmb/")]
