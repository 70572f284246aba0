"""A cell of the benchmark at a size the CPU holds: 32 px frames, batches
of 8, the program's augment patched to the same output size, the whole
run (set-up, window, check) driven through ``run.run_cell`` on the CPU."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness, run

PX = 32
BATCH = 8
SEED = 2 ** 31 + 977


def sized(workload: str):
    c = harness.cell(workload)
    cfg = copy.deepcopy(harness.config(c["config"]))
    cfg["sizes"]["image_px"] = PX
    tr = dict(harness.traffic(c["traffic"]))
    tr.update(batch=BATCH, frame_px=PX, pool_batches=3, trace_steps=2)
    return cfg, tr


def patch_augment(monkeypatch):
    from multimodal_baby_tpu_torch.data import augment
    monkeypatch.setattr(augment.augment_batch, "__defaults__",
                        (PX,) + augment.augment_batch.__defaults__[1:])


def run_tiny(workload: str, monkeypatch, trace: bool = False,
             seed: int = SEED, **overrides) -> dict:
    torch.set_num_threads(2)
    patch_augment(monkeypatch)
    cfg, tr = sized(workload)
    return run.run_cell(workload, seed, 0.5, trace, "cpu",
                        time.perf_counter(),
                        {"config": cfg, "traffic": tr, **overrides})
