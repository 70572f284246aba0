"""The embed loop: ``evaluation/linear_probe.py::extract_features`` at
the mix's chunk (the probe's and the embedding analyses' path: the frozen
trunk on running statistics, so the ResNeXt runs its kernel plan), one
call per chunk in a closed loop over a pool of seeded frames. Each call
returns its embeddings on the host; every call's output is kept, and a
sample drawn from the seed is compared with the plain reference once
the window has closed (``benchmark/check.py``)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import check, program
from benchmark.counters import cvcl as counters
from benchmark.harness import sub_seed
from benchmark.reference import cvcl as ref
from benchmark.reference.weights import make_weights


def run(ctx: dict) -> dict:
    from multimodal_baby_tpu_torch.evaluation.linear_probe import (
        extract_features)
    extract = ctx.get("extract_features", extract_features)
    cfg, tr, seed, device = (ctx["config"], ctx["traffic"], ctx["seed"],
                             ctx["device"])
    cuda = torch.device(device).type == "cuda"
    b = tr["batch"]
    exp = program.experiment(cfg, tr, seed)
    spec = ref.model_spec(cfg)
    t_imports = time.perf_counter()
    weights = make_weights(spec, sub_seed(seed, "weights"), device)
    t_weights = time.perf_counter()
    model = program.build_model(exp, weights, device)
    del weights
    model.eval()
    t_model = time.perf_counter()
    pool = program.frame_pool(tr, seed, device)
    t_pool = time.perf_counter()
    i = 0

    def step():
        nonlocal i
        out = extract(model, pool[i % len(pool)], b)
        i += 1
        return out

    for _ in range(tr["warmup_calls"]):
        step()
    clock = program.Clock(device)
    clock.sync()
    t_ready = time.perf_counter()
    facts = {"setup_s": t_ready - ctx["t_start"],
             "setup_parts": {"imports_s": t_imports - ctx["t_start"],
                             "weights_s": t_weights - t_imports,
                             "model_s": t_model - t_weights,
                             "pool_s": t_pool - t_model,
                             "steps_s": t_ready - t_pool}}

    spans = program.TrunkSpans(model, clock) if ctx["trace"] else None
    if spans:
        spans.on = True
    first = i
    marks, outputs = [clock.mark()], []
    t0 = time.perf_counter()
    while True:
        outputs.append(step())
        marks.append(clock.mark())
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    calls = len(outputs)
    facts.update(
        kind="embed", batch=b, steps=calls, window_s=window_s,
        step_ms=[clock.ms(a, c) for a, c in zip(marks, marks[1:])],
        step_flops=counters.embed_flops(cfg, b),
        trunk_flops_step=counters.trunk_flops(cfg, b),
        trunk_bytes_step=counters.trunk_bytes(cfg, b))
    if spans:
        spans.on = False
        facts["trunk_ms"] = spans.ms()
        spans.remove()
        facts["trace"] = ctx["profile"](step, tr["trace_steps"])
    facts["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                  if cuda else 0)
    del model, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rng = np.random.default_rng(sub_seed(seed, "sample"))
    picked = sorted(rng.choice(calls, size=min(tr["check_calls"], calls),
                               replace=False).tolist())
    t_check = time.perf_counter()
    facts["readings"] = check.embed(
        cfg, spec, seed, device,
        [(pool[(first + k) % len(pool)], outputs[k]) for k in picked])
    facts["check_s"] = time.perf_counter() - t_check
    return facts
