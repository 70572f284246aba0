#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernel and drive its main path on one GPU.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. The card's name and power limit; the build of the K1 kernel
   (``multimodal_baby_tpu_torch/ops/csrc/bottleneck.cu``) with nvcc.
2. K1 (``fused_bottleneck``) against its plain PyTorch version on the
   same bf16 inputs with the same rounding points, for four small and
   odd-sized cases at B = 8 and the 8 distinct ResNeXt-50 block shapes at
   224 px and B = 128: max error relative to the largest output <= 1e-2,
   cosine >= 0.9999. Then the time of each version at B = 128 (CUDA
   events; the plain version computes in f32 with TF32 off).
3. The slice: the flagship CVCL (ResNeXt-50 at full width with seeded
   random weights and BN statistics, flat 512-d head, embedding text
   encoder, fixed T = 0.07, running BN, no int8), 3 AdamW train steps at
   B = 128 on 224x224 uint8 frames with the augment on, then one eval
   step. Checks: finite losses, 16 K1 launches per forward, trunk
   parameters bit-unchanged, heads changed. The eval forward's pooled
   features and logits against the plain bf16 conv path on the same
   weights: per-row cosine >= 0.999; the cosine against the f32 conv path
   (TF32 off) is printed. Then the step time and the trunk time of both
   paths.

Prints one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from multimodal_baby_tpu_torch.core.config import (
    DataConfig, ExperimentConfig, ModelConfig, TextConfig, TrainConfig,
    VisionConfig)
from multimodal_baby_tpu_torch.core.constants import MAX_LEN_UTTERANCE
from multimodal_baby_tpu_torch.data.augment import augment_batch
from multimodal_baby_tpu_torch.models.multimodal import CVCL, l2_normalize
from multimodal_baby_tpu_torch.models.vision_resnext import InferenceBN
from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.bottleneck import (
    bottleneck_reference, fused_bottleneck)
from multimodal_baby_tpu_torch.train.step import (
    init_train_state, make_eval_step, make_train_step)

BATCH = 128          # the slice's batch: K1 is checked and timed at it
CHECK_BATCH = 8      # the batch of the small and odd-sized K1 checks
VOCAB = 2350
REL_TOL = 1e-2
COS_TOL = 0.9999
SLICE_COS_TOL = 0.999
TRAIN_STEPS = 3
TIMED_STEPS = 10

# (name, H, Cin, width, Cout, stride, downsample, blocks per forward)
BLOCKS_224 = [
    ("layer1.0", 56, 64, 128, 256, 1, True, 1),
    ("layer1.1", 56, 256, 128, 256, 1, False, 2),
    ("layer2.0", 56, 256, 256, 512, 2, True, 1),
    ("layer2.1", 28, 512, 256, 512, 1, False, 3),
    ("layer3.0", 28, 512, 512, 1024, 2, True, 1),
    ("layer3.1", 14, 1024, 512, 1024, 1, False, 5),
    ("layer4.0", 14, 1024, 1024, 2048, 2, True, 1),
    ("layer4.1", 7, 2048, 1024, 2048, 1, False, 2),
]
# correctness only: layer 4 at 64 px (4x4 -> 2x2), and odd spatial sizes
BLOCKS_EDGE = [
    ("layer4.0@64px", 4, 1024, 1024, 2048, 2, True, 0),
    ("layer4.1@64px", 2, 2048, 1024, 2048, 1, False, 0),
    ("odd 7->4 stride 2", 7, 512, 256, 512, 2, True, 0),
    ("odd 5x5 stride 1", 5, 256, 128, 256, 1, False, 0),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def random_block(gen, H, cin, width, cout, stride, has_ds, batch):
    """bf16 post-ReLU input and folded weights of one block, on the card."""
    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) * math.sqrt(2.0 / fan_in)
                ).to("cuda", torch.bfloat16)

    def b(n):
        return (0.1 * torch.randn(n, generator=gen)).to("cuda")

    fw = {"w1": w(cin, width, fan_in=cin), "b1": b(width),
          "w2": w(3, 3, width // 32, width, fan_in=9 * width // 32),
          "b2": b(width),
          "w3": w(width, cout, fan_in=width), "b3": b(cout)}
    if has_ds:
        fw["wd"] = w(cin, cout, fan_in=cin)
        fw["bd"] = b(cout)
    x = torch.randn(batch, H, H, cin, generator=gen).clamp_min(0.0)
    return x.to("cuda", torch.bfloat16), fw


def cosine(a, b):
    # in f64: an f32 dot over the tens of millions of outputs of one block
    # at B = 128 is itself off in the fourth digit
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def row_cosines(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_block(name, x, fw, s) -> float:
    """K1 against its plain version on one input; returns the max abs error."""
    got = fused_bottleneck(x, fw, stride=s)
    want = bottleneck_reference(x, fw, stride=s)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-12)
    cos = cosine(got, want)
    log(f"  K1 {name:18s} out {tuple(got.shape)}: max_abs_err {err:.4g} "
        f"rel {rel:.3e} cos {cos:.7f}")
    if not (math.isfinite(rel) and rel <= REL_TOL and cos >= COS_TOL):
        raise AssertionError(
            f"K1 {name}: rel {rel:.3e} (<= {REL_TOL}) cos {cos:.7f} "
            f"(>= {COS_TOL})")
    return err


def phase_kernels():
    gen = torch.Generator().manual_seed(1)
    max_abs = 0.0
    for name, H, cin, width, cout, s, ds, _ in BLOCKS_EDGE:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, CHECK_BATCH)
        max_abs = max(max_abs, check_block(name, x, fw, s))

    # the trunk's block shapes at the slice's batch: checked, then timed
    kernel_ms = plain_ms = 0.0
    for name, H, cin, width, cout, s, ds, count in BLOCKS_224:
        x, fw = random_block(gen, H, cin, width, cout, s, ds, BATCH)
        max_abs = max(max_abs, check_block(name, x, fw, s))
        run_k = lambda: fused_bottleneck(x, fw, stride=s)  # noqa: E731
        run_p = lambda: bottleneck_reference(x, fw, stride=s)  # noqa: E731
        # in turns: plain, kernel, kernel, plain
        p1 = time_ms(run_p, 5)
        k1 = time_ms(run_k, 20)
        k2 = time_ms(run_k, 20)
        p2 = time_ms(run_p, 5)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        flops = 2 * BATCH * (
            H * H * cin * width
            + (H // s) ** 2 * (9 * width // 32 * width + width * cout
                               + (cin * cout if ds else 0)))
        log(f"  K1 {name} B={BATCH}: kernel {k1:.3f}/{k2:.3f} ms, plain f32 "
            f"{p1:.3f}/{p2:.3f} ms, kernel {flops / k / 1e9:.1f} TFLOP/s")
        kernel_ms += count * k
        plain_ms += count * p
        del x, fw
    log(f"  K1 over the 16 blocks of one forward at B={BATCH}: kernel "
        f"{kernel_ms:.3f} ms, plain f32 {plain_ms:.3f} ms")
    return max_abs, kernel_ms, plain_ms


def make_batch(rng, b):
    """Synthetic uint8 frames and token ids, as bench.py makes them."""
    images = rng.randint(0, 256, (b, 224, 224, 3), np.uint8)
    text = np.zeros((b, MAX_LEN_UTTERANCE), np.int64)
    lens = rng.randint(1, MAX_LEN_UTTERANCE - 1, b)
    text[:, 0] = 2
    for i, n in enumerate(lens):
        text[i, 1:1 + n] = rng.randint(4, VOCAB, n)
        text[i, 1 + n] = 3
    return {"image_u8": torch.from_numpy(images).cuda(),
            "text": torch.from_numpy(text).cuda(),
            "text_len": torch.from_numpy(lens + 2).cuda()}


def phase_slice():
    cfg = ExperimentConfig(
        model=ModelConfig(
            embedding_dim=512, vocab_size=VOCAB, embedding_type="flat",
            normalize_features=True, fix_temperature=True, temperature=0.07,
            vision=VisionConfig(cnn_dino=True, frozen_bn="running",
                                trunk_int8=False),
            text=TextConfig(text_encoder="embedding")),
        data=DataConfig(augment_frames=True),
        train=TrainConfig(optimizer="AdamW", lr=1e-4, weight_decay=0.1))
    gen = torch.Generator().manual_seed(0)
    model = CVCL(cfg.model, dtype=torch.bfloat16, device="cuda",
                 generator=gen)
    trunk = model.vision_encoder.model
    with torch.no_grad():  # non-trivial BN statistics, so the fold matters
        for m in trunk.modules():
            if isinstance(m, InferenceBN):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
    batch = make_batch(np.random.RandomState(0), BATCH)
    state = init_train_state(model, cfg, device="cuda")
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)

    frozen = {k: v.clone() for k, v in trunk.state_dict().items()
              if not k.startswith("fc.")}
    heads = {"vision_encoder.model.fc.weight": trunk.fc.weight.detach().clone(),
             "text_encoder.embedding.weight":
                 model.text_encoder.embedding.weight.detach().clone()}

    torch.cuda.synchronize()
    fused_bottleneck.launches = 0
    t0 = time.perf_counter()
    losses = [float(train_step(state, batch)["loss"])
              for _ in range(TRAIN_STEPS)]
    eval_loss = float(eval_step(batch)["loss"])
    torch.cuda.synchronize()
    launches = fused_bottleneck.launches
    first_s = time.perf_counter() - t0
    forwards = TRAIN_STEPS + 1
    log(f"  losses {losses}, eval loss {eval_loss:.5f} ({first_s:.2f} s "
        f"for the first {TRAIN_STEPS} steps + eval, fold included)")
    log(f"  K1 launches {launches} over {forwards} forwards")
    if not all(math.isfinite(v) for v in losses + [eval_loss]):
        raise AssertionError(f"non-finite loss: {losses}, eval {eval_loss}")
    if launches != 16 * forwards:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{16 * forwards}")
    for k, v in trunk.state_dict().items():
        if k in frozen and not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen trunk tensor {k} changed")
    named = dict(model.named_parameters())
    for k, v in heads.items():
        if torch.equal(named[k].detach(), v):
            raise AssertionError(f"head {k} did not change")
    log(f"  trunk unchanged ({len(frozen)} tensors), heads updated")

    with torch.no_grad():
        img_bf16 = augment_batch(batch["image_u8"], augment=False,
                                 dtype=torch.bfloat16)
        img_f32 = augment_batch(batch["image_u8"], augment=False)
        txt, _ = model.encode_text(batch["text"], batch["text_len"])

        def logits(pooled):
            f = l2_normalize(trunk.fc(pooled), dim=1)
            return model.similarity(f, txt) * model.logit_scale()

        pooled_k = trunk.forward_folded(img_bf16)["pooled"]
        pooled_p = trunk.forward_conv(img_bf16)["pooled"]
        pooled_f = trunk.forward_conv(img_f32)["pooled"]
        for what, a, b_, c in (
                ("pooled", pooled_k, pooled_p, pooled_f),
                ("logits", logits(pooled_k), logits(pooled_p),
                 logits(pooled_f))):
            cp, cf = row_cosines(a, b_), row_cosines(a, c)
            cpf = row_cosines(b_, c)
            log(f"  eval {what}: kernel vs plain bf16 cos min "
                f"{float(cp.min()):.7f} mean {float(cp.mean()):.7f}; "
                f"kernel vs f32 min {float(cf.min()):.7f}; plain bf16 vs "
                f"f32 min {float(cpf.min()):.7f}")
            if not (torch.isfinite(a).all() and float(cp.min())
                    >= SLICE_COS_TOL):
                raise AssertionError(
                    f"eval {what}: cosine {float(cp.min()):.7f} < "
                    f"{SLICE_COS_TOL}")

        img_aug = augment_batch(batch["image_u8"], dtype=torch.bfloat16)
        trunk_k = time_ms(lambda: trunk.forward_folded(img_aug), 10)
        trunk_p = time_ms(lambda: trunk.forward_conv(img_aug), 10)
    log(f"  trunk forward B={BATCH}: K1 path {trunk_k:.3f} ms, plain bf16 "
        f"conv path {trunk_p:.3f} ms")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    log(f"  train step B={BATCH}: {step_s * 1e3:.3f} ms, "
        f"{BATCH / step_s:.1f} pairs/s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"  built {lib_path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 2: K1 against its plain version")
    max_abs, kernel_ms, plain_ms = phase_kernels()

    log("phase 3: the slice")
    launches = phase_slice()

    print(json.dumps({"kernels": [{
        "name": "fused_bottleneck", "route": "cuda",
        "source": "multimodal_baby_tpu_torch/ops/csrc/bottleneck.cu",
        "replaces": "multimodal_baby_tpu/ops/bottleneck_hwbc.py:408",
        "launches": launches, "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
