#!/usr/bin/env python3
"""Where the PyTorch port's train step spends its time on the card.

Builds one of ``chip_smoke.py``'s slices (seeded random weights, B = 128,
augment on): the ViT flagship (``vit``) in the kernel configuration
``--vit-kernels`` (``default``: K5 and K6; or one of chip_smoke.py's
phase-6 configurations, e.g. ``whole_block``), the ResNeXt flagship in bf16 with
every stage block by block (``resnext``, phase 3), the published ResNeXt
recipe, int8 layers 3-4 in the default kernel plan, calibrated first
(``int8``, phase 5; with ``--trunk-int8 t`` or ``t,t,1,1`` that model under
an int8-transport plan instead, phase 8; ``--stem`` switches its stem to
one of chip_smoke.py's phase-14e forms), or that trunk with the LSTM
text encoder in the LSTM contrastive recipe (``lstm``, phase 7a) with
``--fused-lstm none`` (the JAX length rule: the plain scan at L = 25) or
``true`` (K9). It runs a few
warm-up steps, times steps on the host clock without the profiler, then
traces steps with ``torch.profiler`` and prints the device time per step
by kernel name, the kernel time per step, the device's busy share (kernel
time over step time) and, for ``lstm``, the share of the step that K9
takes. With ``--distributed`` the step runs through the distributed path
(``parallel/``: an nccl process group of one rank through a ``file://``
store, mesh (1, 1)). The host's time per step by operator (self time)
follows the kernels. Run from the root of the repository on a machine with
an NVIDIA GPU:

    python3 scripts/profile_torch_step.py [--slice vit|resnext|int8|lstm]
        [--vit-kernels default|attn=1|attn=pairs|attn=qkv|whole_block|
        gelu=tanh|int8|lnfold|int8+lnfold|lnfold attn=qkv]
        [--fused-lstm none|true] [--trunk-int8 0,0,1,1|t|t,t,1,1]
        [--stem conv7|s2d|split|cpad|s2d+cpad] [--steps 5] [--distributed]
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from multimodal_baby_tpu_torch.train.step import (  # noqa: E402
    calibrate_trunk, init_train_state, make_train_step)


def build(which: str, vit_kernels: str, fused_lstm: str, trunk_int8: str,
          stem: str):
    if which == "vit":
        cfg, model, batch = chip_smoke.build_vit_slice()
        if vit_kernels != "default":
            model.vision_encoder.model.vit_kernels = \
                chip_smoke.VIT_CONFIGS[vit_kernels][0]
        return cfg, model, batch
    if which == "resnext":
        return chip_smoke.build_resnext_slice(False, ("blocks",) * 4)
    if which == "lstm":
        cfg, model, batch = chip_smoke.build_lstm_slice()
        model.text_encoder.fused_lstm = {"none": None, "true": True}[
            fused_lstm]
        return cfg, model, batch
    plan = chip_smoke.MIXED if trunk_int8 == "0,0,1,1" else trunk_int8
    cfg, model, batch = chip_smoke.build_resnext_slice(plan, None)
    calibrate_trunk(model, batch)
    chip_smoke.set_stem(model, *chip_smoke.STEM_CONFIGS[stem])
    return cfg, model, batch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", choices=("vit", "resnext", "int8", "lstm"),
                    default="vit")
    ap.add_argument("--fused-lstm", choices=("none", "true"), default="true")
    ap.add_argument("--vit-kernels", default="default",
                    choices=("default", *chip_smoke.VIT_CONFIGS))
    ap.add_argument("--trunk-int8", choices=("0,0,1,1", "t", "t,t,1,1"),
                    default="0,0,1,1")
    ap.add_argument("--stem", choices=tuple(chip_smoke.STEM_CONFIGS),
                    default="conv7")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    cfg, model, batch = build(args.slice, args.vit_kernels, args.fused_lstm,
                              args.trunk_int8, args.stem)
    mesh = None
    if args.distributed:
        import tempfile
        import torch.distributed as dist
        from multimodal_baby_tpu_torch.parallel.mesh import create_mesh
        store = Path(tempfile.mkdtemp()) / "store"
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
        mesh = create_mesh((1, 1))
    state = init_train_state(model, cfg, mesh)
    step = make_train_step(model, cfg, mesh)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation):
            by_name[evt.name] += evt.device_time_total / 1e3 / args.steps
            launches[evt.name] += 1
    kernel_ms = sum(by_name.values())
    if not kernel_ms:
        print("profile_torch_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    what = ("distributed (1, 1) " if mesh else "") + args.slice + {
        "vit": f" ({args.vit_kernels})",
                         "lstm": f" (fused_lstm={args.fused_lstm})",
                         "int8": f" (trunk_int8={args.trunk_int8}, stem "
                                 f"{args.stem})"}.get(
                             args.slice, "")
    print(f"{what} train step B={chip_smoke.BATCH}: {step_ms:.3f} ms "
          f"without the profiler; device time {kernel_ms:.3f} ms per step; "
          f"busy {100 * kernel_ms / step_ms:.1f}%")
    if args.slice == "lstm":
        k9_ms = sum(ms for name, ms in by_name.items()
                    if "lstm_kernel" in name)
        print(f"K9 (lstm_kernel): {k9_ms:.3f} ms per step, "
              f"{100 * k9_ms / step_ms:.2f}% of the step")
    print(f"{'ms/step':>9} {'calls/step':>10}  kernel")
    for name, ms in by_name.most_common(30):
        print(f"{ms:9.3f} {launches[name] / args.steps:10.1f}  {name[:110]}")
    print(f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    host = collections.Counter()
    for evt in prof.key_averages():
        host[evt.key] = evt.self_cpu_time_total / 1e3 / args.steps
    print(f"{'host ms/step':>12}  operator (self time)")
    for name, ms in host.most_common(20):
        print(f"{ms:12.3f}  {name[:110]}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
