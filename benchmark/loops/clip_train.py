"""The CLIP train loop: ``loops/train.py``'s calls once a step,
``train_step(state, device_batch(batch, device, staging))`` through one
``HostStaging``, in a closed loop over the mix's pool of host batches, for
a configuration that trains both towers (``reference/clip_vit_l14.py``):
captions of CLIP's tokens, every leaf trained, CLIP's AdamW and logit
scale.

Set-up, window and trace run as in ``loops/train.py``; the traced block
also reads ``PlainVJP.backward_calls`` before and after it (None where
the program has no such counter). Then the program is freed and the
plain reference follows the check steps from the seed; the numbers are
``check.train_gaps``', every leaf's gradient and change included."""

from __future__ import annotations

import gc
import time
from typing import List

import numpy as np
import torch

from benchmark import check, program
from benchmark.counters import clip_vit_l14 as counters
from benchmark.harness import sub_seed
from benchmark.reference import clip_vit_l14 as ref
from benchmark.reference.adamw import first_moment_to_grad
from benchmark.reference.cvcl import set_precision


def captions(n: int, tokens, context: int, vocab: int, seed: int):
    """(ids [n, context] int32, lengths [n] int32): start-of-text (CLIP's
    second-last id, 49406), ``tokens[0]`` to ``tokens[1]`` tokens uniform
    over the ids below it, end-of-text (the last, 49407), zero padding."""
    sot, eot = vocab - 2, vocab - 1
    rng = np.random.default_rng(sub_seed(seed, "captions"))
    k = rng.integers(tokens[0], tokens[1] + 1, size=n)
    ids = rng.integers(0, sot, size=(n, context), dtype=np.int64)
    pos = np.arange(context)[None, :]
    text = np.where((pos >= 1) & (pos <= k[:, None]), ids, 0)
    text[:, 0] = sot
    text[np.arange(n), k + 1] = eot
    return text.astype(np.int32), (k + 2).astype(np.int32)


def train_pool(cfg: dict, tr: dict, seed: int, device) -> List[dict]:
    frames = program.frame_pool(tr, seed, device)
    b, s = tr["batch"], cfg["sizes"]
    text, lens = captions(len(frames) * b, tr["caption_tokens"],
                          s["max_len"], s["vocab_size"], seed)
    return [{"image_u8": f, "text": text[i * b:(i + 1) * b],
             "text_len": lens[i * b:(i + 1) * b]}
            for i, f in enumerate(frames)]


def reference_train(cfg: dict, seed: int, batches, device, **kw):
    """(losses, first gradients, leaves after the steps, first vision
    features, starting weights) of the reference, from the seed alone."""
    set_precision()
    w = ref.initial_weights(cfg, sub_seed(seed, "weights"), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "generator"))
    return (*ref.train(cfg, w, batches, gen, device, **kw), w)


def control_readings(cfg: dict, tr: dict, seed: int, device) -> list:
    """The control (the reference with fp8 products) and the fault (half
    of each batch left out), each against the reference, on the check
    steps' batches."""
    from benchmark.reference.quant import fp8
    pool = train_pool(cfg, tr, seed, device)[:tr["check_steps"]]
    r = reference_train(cfg, seed, pool, device)
    out = []
    for what, kw in (("control_fp8", {"quant": fp8}),
                     ("fault_half_batch", {"half_batch": True})):
        p = reference_train(cfg, seed, pool, device, **kw)
        out.append((what, check.train_gaps(*p[:4], *r[:4], r[4])))
    return out


def run(ctx: dict) -> dict:
    from multimodal_baby_tpu_torch.ops import vit_common
    from multimodal_baby_tpu_torch.train.step import (
        HostStaging, device_batch, init_train_state, make_train_step)
    cfg, tr, seed, device = (ctx["config"], ctx["traffic"], ctx["seed"],
                             ctx["device"])
    cuda = torch.device(device).type == "cuda"
    exp = program.experiment(cfg, tr, seed)
    t_imports = time.perf_counter()
    weights = ref.initial_weights(cfg, sub_seed(seed, "weights"), device)
    t_weights = time.perf_counter()
    model = program.build_model(exp, weights, device)
    del weights
    t_model = time.perf_counter()
    state = init_train_state(model, exp)
    train_step = ctx.get("make_train_step", make_train_step)(model, exp)
    staging = HostStaging() if cuda else None
    t_state = time.perf_counter()
    pool = train_pool(cfg, tr, seed, device)
    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    if len(names) != len(params):
        raise RuntimeError(f"the program freezes leaves the configuration "
                           f"trains: {sorted(set(params) - set(names))[:5]}")
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
    hook = trunk.register_forward_hook(
        lambda m, a, out: feats.append(out.detach().float().clone()))
    losses, first_m = [], {}
    for k in range(tr["check_steps"]):
        losses.append(step()["loss"])
        if k == 0:
            hook.remove()
            first_m = {n: state.optimizer.state[params[n]]["exp_avg"].clone()
                       for n in names}
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
    b = tr["batch"]
    facts.update(
        kind="train", batch=b, steps=steps, window_s=window_s,
        step_ms=[clock.ms(a, c) for a, c in zip(marks, marks[1:])],
        step_flops=counters.train_step_flops(cfg, b),
        trunk_flops_step=counters.trunk_flops(cfg, b),
        trunk_bytes_step=counters.trunk_bytes(cfg, b),
        trunk_vjp_flops_step=counters.trunk_vjp_flops(cfg, b),
        trunk_vjp_bytes_step=counters.trunk_vjp_bytes(cfg, b))
    nonfinite = int((~torch.isfinite(torch.stack(window_losses))).sum())
    if spans:
        spans.on = False
        facts["trunk_ms"] = spans.ms()
        spans.remove()
        calls = getattr(vit_common.PlainVJP, "backward_calls", None)
        facts["trace"] = ctx["profile"](step, tr["trace_steps"])
        if calls is not None:
            facts["vjp_calls_per_step"] = (
                vit_common.PlainVJP.backward_calls - calls) / tr["trace_steps"]
    facts["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                  if cuda else 0)

    del model, trunk, state, train_step, staging, params, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    losses_r, grads_r, after_r, feats_r, start = reference_train(
        cfg, seed, pool[:tr["check_steps"]], device)
    grads_p = {n: first_moment_to_grad(m, cfg["optimizer"]["betas"][0])
               for n, m in first_m.items()}
    facts["readings"] = check.train_gaps(losses, grads_p, after, feats[0],
                                         losses_r, grads_r, after_r, feats_r,
                                         start)
    facts["readings"]["nonfinite_window_losses"] = nonfinite
    facts["check_s"] = time.perf_counter() - t_check
    return facts
