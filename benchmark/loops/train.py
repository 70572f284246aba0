"""The train loop: the calls ``train/trainer.py`` makes once a step,
``train_step(state, device_batch(batch, device, staging))`` through one
``HostStaging``, in a closed loop over the mix's pool of host batches.

Set-up builds one ``TrainState`` and drives it through the mix's
``check_steps`` first steps (distinct rows), keeping the trunk's
features and the first moments of the first step (the features through a
forward hook the benchmark puts on the trunk), the leaves after the last
check step and each step's loss; then ``warmup_steps`` more. The same object runs the window, with
no host sync inside it: the loss stays on the device until the window
ends. After the window (and, with a trace, a profiled block of
``trace_steps`` steps) the program is freed and the plain reference
follows the check steps from the seed (``benchmark/check.py``)."""

from __future__ import annotations

import gc
import time

import torch

from benchmark import check, program
from benchmark.counters import cvcl as counters
from benchmark.harness import sub_seed
from benchmark.reference import cvcl as ref
from benchmark.reference.weights import make_weights


def run(ctx: dict) -> dict:
    from multimodal_baby_tpu_torch.train.step import (
        HostStaging, device_batch, init_train_state, make_train_step)
    cfg, tr, seed, device = (ctx["config"], ctx["traffic"], ctx["seed"],
                             ctx["device"])
    cuda = torch.device(device).type == "cuda"
    exp = program.experiment(cfg, tr, seed)
    spec = ref.model_spec(cfg)
    t_imports = time.perf_counter()
    weights = make_weights(spec, sub_seed(seed, "weights"), device)
    t_weights = time.perf_counter()
    model = program.build_model(exp, weights, device)
    del weights
    t_model = time.perf_counter()
    state = init_train_state(model, exp)
    train_step = ctx.get("make_train_step", make_train_step)(model, exp)
    staging = HostStaging() if cuda else None
    t_state = time.perf_counter()
    pool = program.train_pool(cfg, tr, seed, device)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    if sorted(names) != sorted(ref.trainable(cfg, [n for n, *_ in spec])):
        raise RuntimeError(f"the program trains other leaves than the "
                           f"configuration states: {sorted(names)}")
    params = dict(model.named_parameters())
    t_pool = time.perf_counter()

    i = 0

    def step():
        nonlocal i
        out = train_step(state, device_batch(pool[i % len(pool)], device,
                                             staging))
        i += 1
        return out

    trunk = model.vision_encoder.model
    feats = []
    hook = trunk.register_forward_hook(lambda m, a, out: feats.append(
        (out["pooled"] if isinstance(out, dict) else out).detach().float()
        .clone()))
    losses, first_m = [], {}
    for k in range(tr["check_steps"]):
        losses.append(step()["loss"])
        if k == 0:
            hook.remove()
            first_m = {n: state.optimizer.state[params[n]]["exp_avg"].clone()
                       if params[n] in state.optimizer.state
                       else torch.zeros_like(params[n]) for n in names}
    after = {n: params[n].detach().clone() for n in names}
    losses = [float(x) for x in losses]
    for _ in range(tr["warmup_steps"]):
        step()
    clock = program.Clock(device)
    clock.sync()
    t_ready = time.perf_counter()
    facts = {"setup_s": t_ready - ctx["t_start"],
             "setup_parts": {"imports_s": t_imports - ctx["t_start"],
                             "weights_s": t_weights - t_imports,
                             "model_s": t_model - t_weights,
                             "state_s": t_state - t_model,
                             "pool_s": t_pool - t_state,
                             "steps_s": t_ready - t_pool}}

    spans = program.TrunkSpans(model, clock) if ctx["trace"] else None
    if spans:
        spans.on = True
    marks, window_losses = [clock.mark()], []
    t0 = time.perf_counter()
    while True:
        window_losses.append(step()["loss"])
        marks.append(clock.mark())
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    steps = len(marks) - 1
    facts.update(
        kind="train", batch=tr["batch"], steps=steps, window_s=window_s,
        step_ms=[clock.ms(a, b) for a, b in zip(marks, marks[1:])],
        step_flops=counters.train_step_flops(cfg, tr["batch"]),
        trunk_flops_step=counters.trunk_flops(cfg, tr["batch"]),
        trunk_bytes_step=counters.trunk_bytes(cfg, tr["batch"]))
    nonfinite = int((~torch.isfinite(torch.stack(window_losses))).sum())
    if spans:
        spans.on = False
        facts["trunk_ms"] = spans.ms()
        spans.remove()
        facts["trace"] = ctx["profile"](step, tr["trace_steps"])
    facts["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                  if cuda else 0)

    del model, trunk, state, train_step, staging, params, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    facts["readings"] = check.train(
        cfg, exp, spec, seed, pool[:tr["check_steps"]], device,
        losses, first_m, after, feats[0])
    facts["readings"]["nonfinite_window_losses"] = nonfinite
    facts["check_s"] = time.perf_counter() - t_check
    return facts
