#!/usr/bin/env python3
"""Where K9's and K4's time goes (``csrc/lstm.cu``, ``csrc/infonce.cu``).

1. Per call, at the shapes of ``chip_smoke.py`` phase 2e (K9 at (B, L, H)
   = (128, 25, 512) and (128, 64, 512); K4's forward and backward at
   B = 128 and 1024, E = 512): the CUDA-event time of a call
   (``chip_smoke.time_ms``, as ``time_in_turns`` takes it) beside the
   profiler's device time of the kernels one call launches, kernel by
   kernel (``chip_smoke.profiled_ms``; a fill launch shows up here), and
   the host's time a call (the host clock over 50 calls not waited on), so
   that what the host costs is told apart from what the device costs.
   Then K4's forward at B = 128 on the host, piece by piece.
2. K9's timeline per time step: ``lstm.cu`` of the checkout named by
   ``--tree`` (default this one), compiled alone with thread 0 of every
   block storing ``clock64`` at the step's events, split into the publish
   of the previous step's h (the tensor-core kernel's fence and flag), the
   wait for the other blocks (the barrier), the copy of h_{t-1} until its
   first chunk is in shared memory, the products h . W_hh (with the later
   chunks' waits), and the gates with their stores. The cycles are turned
   into microseconds with the share of the step they take and the event
   time of the probe build's call. ``--variants``: the same for builds of
   the tensor-core kernel with its mma, its TF32 split or its whole product
   loop taken out (their outputs are not used).

The stamps are put in by text substitution at anchors of the source; the
script knows the anchors of both K9 designs (the first, FMA kernel and the
tensor-core kernel that replaced it) and takes the set the source holds.
Builds go to ``build/probe_recurrent/`` (git-ignored). Needs an NVIDIA GPU
and the CUDA toolkit:

    python3 scripts/probe_recurrent.py [--tree DIR] [--skip-calls]
        [--variants]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "probe_recurrent"
STEPS_KEPT = 128   # steps of the timeline kept per block
SLOTS = 8          # stamps per step
SEGMENTS = ("publish", "barrier wait", "h copy", "products", "gates")

STAMP_HELPER = r"""
__device__ unsigned long long lstm_trace[132 * 128 * 8];
__device__ __forceinline__ void lstm_stamp(int t, int e) {
  if (threadIdx.x == 0 && t < 128 && blockIdx.x < 132) {
    unsigned long long c;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
    lstm_trace[(blockIdx.x * 128 + t) * 8 + e] = c;
  }
}

"""
TRACE_READ = r"""
extern "C" int mmb_lstm_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, lstm_trace,
                                               sizeof(lstm_trace)));
}
"""
# (anchor, replacement) per design; stamp e of step t: 0 the step's wait
# begins, 1 the wait is over, 2 the first of h_{t-1} is in shared memory,
# 3 the products are done, 4 the gates are stored
ANCHORS = {
    # the FMA kernel: a grid barrier ends each step (its wait is from stamp
    # 4 of step t - 1 to stamp 1 of step t), then the h copy in two chunks
    # under the products
    "fma": [
        ("__global__ void __launch_bounds__(LSTM_THREADS, 1)\n",
         STAMP_HELPER + "__global__ void __launch_bounds__(LSTM_THREADS, "
         "1)\n"),
        ("  for (int t = 0; t < p.L; ++t) {\n",
         "  for (int t = 0; t < p.L; ++t) {\n    lstm_stamp(t, 1);\n"),
        ("        half_sync(half);\n",
         "        half_sync(half);\n        if (c == 0) lstm_stamp(t, 2);\n"),
        ("      if (half == 1) {\n",
         "      lstm_stamp(t, 3);\n      if (half == 1) {\n"),
        ("      __syncthreads();  // the next tile overwrites Hs and red\n",
         "      __syncthreads();  // the next tile overwrites Hs and red\n"
         "      lstm_stamp(t, 4);\n"),
    ],
    # the tensor-core kernel: the wait opens the step
    "mma": [
        ("__global__ void __launch_bounds__(K9_THREADS, 1)\n",
         STAMP_HELPER + "__global__ void __launch_bounds__(K9_THREADS, 1)\n"),
        ("    // step t: wait for h_{t-1}\n",
         "    lstm_stamp(t, 0);\n    // step t: wait for h_{t-1}\n"),
        ("    // the wait is over\n",
         "    lstm_stamp(t, 1);\n    // the wait is over\n"),
        ("    // the first chunk of h_{t-1} is in\n",
         "    lstm_stamp(t, 2);\n    // the first chunk of h_{t-1} is in\n"),
        ("    // the products are in\n",
         "    lstm_stamp(t, 3);\n    // the products are in\n"),
        ("    // this step's h is out\n",
         "    lstm_stamp(t, 4);\n    // this step's h is out\n"),
        ("    // the gate sums are in shared memory\n",
         "    lstm_stamp(t, 5);\n    // the gate sums are in shared memory\n"),
        ("      // this thread's h, c and out\n",
         "      lstm_stamp(t, 6);\n      // this thread's h, c and out\n"),
    ],
}


# builds of the tensor-core kernel with a part of its products taken out
# (timed and taken apart, their outputs not used)
SPLITS = ("        split_tf32(a.x, ahi[0], alo[0]);\n"
          "        split_tf32(a.y, ahi[1], alo[1]);\n"
          "        split_tf32(a.z, ahi[2], alo[2]);\n"
          "        split_tf32(a.w, ahi[3], alo[3]);\n")
VARIANTS = {
    "no mma": [("          mma_3xtf32(acc[n], cor[n], ahi, alo, bhi, blo);\n",
                "          acc[n][0] += __uint_as_float(ahi[0] ^ alo[1] ^ "
                "ahi[2] ^ alo[3] ^ bhi[0] ^ blo[1]);\n")],
    "no split": [(SPLITS, "        ahi[0] = alo[0] = __float_as_uint(a.x);\n"
                  "        ahi[1] = alo[1] = __float_as_uint(a.y);\n"
                  "        ahi[2] = alo[2] = __float_as_uint(a.z);\n"
                  "        ahi[3] = alo[3] = __float_as_uint(a.w);\n"),
                 ("          split_tf32(hrow[0], bhi[0], blo[0]);\n"
                  "          split_tf32(hrow[4], bhi[1], blo[1]);\n",
                  "          bhi[0] = blo[0] = __float_as_uint(hrow[0]);\n"
                  "          bhi[1] = blo[1] = __float_as_uint(hrow[4]);\n")],
    "no products": [("      for (int ks = lo + (kq - lo % 4 + 4) % 4; ks < ks_end; "
                     "ks += 4) {\n",
                     "      for (int ks = ks_end; ks < ks_end; ks += 4) {\n")],
}


def build_timeline(tree: Path, name: str = "timeline", subs=()):
    """The tree's lstm.cu with the stamps (and ``subs``), compiled alone;
    returns (design, loaded library)."""
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(tree / "multimodal_baby_tpu_torch" / "ops" / "csrc", src)
    text = (src / "lstm.cu").read_text()
    design = next((d for d, subs in ANCHORS.items()
                   if all(a in text for a, _ in subs)), None)
    if design is None:
        raise RuntimeError("lstm.cu holds neither design's anchors")
    for anchor, new in [*ANCHORS[design], *subs]:
        if anchor not in text:
            raise RuntimeError(f"{name}: lstm.cu no longer holds {anchor!r}")
        text = text.replace(anchor, new, 1)
    (src / "lstm.cu").write_text(text + TRACE_READ)
    proc = subprocess.run(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS, "-o",
         str(src / "lib.so"), str(src / "lstm.cu")],
        capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "spill" in line or "error" in line:
            print(f"  ptxas/nvcc ({design} timeline build): {line.strip()}")
    if proc.returncode:
        raise RuntimeError("the timeline build failed:\n" + proc.stderr[-4000:])
    lib = ctypes.CDLL(str(src / "lib.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mmb_lstm_f32.argtypes = [ptr] * 10 + [i32] * 3 + [ptr]
    lib.mmb_lstm_f32.restype = i32
    lib.mmb_lstm_trace.argtypes = [ptr]
    lib.mmb_lstm_trace.restype = i32
    return design, lib


def timeline(design, lib, L: int, name: str = "") -> None:
    gen = torch.Generator().manual_seed(7)
    args = C.lstm_case(gen, C.BATCH, L, C.LSTM_H)[0]
    B, H = C.BATCH, C.LSTM_H
    dev = args[0].device
    out = torch.empty(L, B, H, device=dev)
    h_last, c_last = torch.empty(B, H, device=dev), torch.empty(B, H,
                                                               device=dev)
    hbuf = torch.empty(2, B, H, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        sync = torch.zeros(4096, dtype=torch.int32, device=dev)
        code = lib.mmb_lstm_f32(*(t.data_ptr() for t in (*args, out, h_last,
                                                       c_last, hbuf, sync)),
                                L, B, H, stream)
        if code:
            raise RuntimeError(f"timeline build: CUDA error {code}")

    ms = C.time_ms(call, 20)
    trace = torch.zeros(132 * STEPS_KEPT * SLOTS, dtype=torch.int64)
    torch.cuda.synchronize()
    lib.mmb_lstm_trace(trace.data_ptr())
    tr = trace.view(132, STEPS_KEPT, SLOTS)[:, :L].double()
    blocks = int((tr[:, 0, 4] != 0).sum())
    tr = tr[:blocks]
    # events of steps 1 .. L-1: the previous step's gates stored, wait
    # begins, wait over, first h in, products done, gates stored (the FMA
    # design waits at once: its publish segment is empty)
    first = tr[:, :-1, 4] if design == "fma" else tr[:, 1:, 0]
    ev = torch.stack([tr[:, :-1, 4], first, tr[:, 1:, 1], tr[:, 1:, 2],
                      tr[:, 1:, 3], tr[:, 1:, 4]], -1)
    seg = (ev[..., 1:] - ev[..., :-1]).clamp(min=0)  # [blocks, L-1, 5]
    step = seg.sum(-1)
    share = seg.sum((0, 1)) / step.sum()
    us_step = ms * 1e3 / L
    print(f"  K9 {design} {name} timeline, (B, L, H) = ({B}, {L}, {H}), {blocks} "
          f"blocks: probe build {ms:.4f} ms a call ({us_step:.3f} us a step);"
          f" mean cycles a step {float(step.mean()):.0f}", flush=True)
    for name, s, cyc in zip(SEGMENTS, share, seg.mean((0, 1))):
        print(f"    {name:13s} {float(cyc):8.0f} cycles  {float(s):6.1%} "
              f"of a step  ~{float(s) * us_step:.3f} us", flush=True)
    if design == "mma":  # the gates taken apart
        parts = (("sums to shared memory", 3, 5), ("gate math", 5, 6),
                 ("stores and the block's sync", 6, 4))
        for what, e0, e1 in parts:
            cyc = float((tr[:, 1:, e1] - tr[:, 1:, e0]).clamp(min=0).mean())
            print(f"      {what:27s} {cyc:8.0f} cycles", flush=True)
    spread = seg[..., 1].mean(1)
    print(f"    barrier wait per block: min {float(spread.min()):.0f}, "
          f"median {float(spread.median()):.0f}, max "
          f"{float(spread.max()):.0f} cycles", flush=True)


def per_call() -> None:
    gen = torch.Generator().manual_seed(7)
    cases = []
    for L in (C.MAX_LEN_UTTERANCE, C.LM_LEN):
        args = C.lstm_case(gen, C.BATCH, L, C.LSTM_H)[0]
        cases.append((f"K9 (B, L, H) = ({C.BATCH}, {L}, {C.LSTM_H})",
                      lambda a=args: C.lstm_fused(*a)))
    nlt = torch.tensor(C.math.log(1 / 0.07), device="cuda")
    g = torch.tensor(1.0, device="cuda")
    for B in C.INFONCE_BATCHES:
        x = torch.randn(2, B, C.INFONCE_E, generator=gen)
        img, txt = C.l2_normalize(x, dim=-1).cuda().unbind(0)
        _, lse_i, lse_t, _ = C.fused_infonce_forward(img, txt, nlt)
        cases.append((f"K4 forward B = {B}", lambda i=img, t=txt:
                      C.fused_infonce_forward(i, t, nlt)))
        cases.append((f"K4 backward B = {B}",
                      lambda i=img, t=txt, a=lse_i, b=lse_t:
                      C.fused_infonce_backward(i, t, nlt, a, b, g)))
    with torch.no_grad():
        for what, fn in cases:
            ev = [C.time_ms(fn, 50) for _ in range(3)]
            dev, kernels = C.profiled_ms(fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):  # the host's part: launches not waited on
                fn()
            host = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            print(f"  {what}: event {statistics.mean(ev):.4f} ms a call "
                  f"(turns {', '.join(f'{v:.4f}' for v in ev)}); profiler "
                  f"device {dev:.4f} ms a call; host {host:.4f} ms a call "
                  f"(50 calls not synchronized)", flush=True)
            for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
                print(f"    {ms:.4f} ms: {name[:70]}", flush=True)


def host_parts() -> None:
    """K4's forward at B = 128 on the host, piece by piece, and the
    cooperative launches of K4 (B = 1024) and K9 alone (us a call, the host
    clock over 200 calls not waited on)."""
    from multimodal_baby_tpu_torch.ops import infonce as I
    gen = torch.Generator().manual_seed(7)
    B, E = C.BATCH, C.INFONCE_E
    x = torch.randn(2, B, E, generator=gen)
    img, txt = C.l2_normalize(x, dim=-1).cuda().unbind(0)
    img, txt = img.contiguous(), txt.contiguous()
    nlt = torch.tensor(C.math.log(1 / 0.07), device="cuda")
    lib = _build.library()
    out = torch.empty(2 * B + 8, device="cuda")
    lse_i, lse_t, loss4, metrics = out.split((B, B, 4, 4))
    stream, bar = _build.sync_words("infonce", 4)
    ptrs = [t.data_ptr() for t in (img, txt, nlt, out, loss4, lse_i, lse_t,
                                   metrics, bar)]
    parts = {
        "the wrapper (fused_infonce_forward)":
            lambda: I.fused_infonce_forward(img, txt, nlt),
        "the ctypes call alone (LaunchCache, cluster launch)":
            lambda: lib.mmb_infonce_fwd_f32(*ptrs, B, E, stream),
        "torch.empty": lambda: torch.empty(2 * B + 8, device="cuda"),
        "split into 4 views": lambda: out.split((B, B, 4, 4)),
        "the checks (_shape, _check)": lambda: (I._shape("x", img), I._check(
            "x", ("img", img, (B, E)), ("txt", txt, (B, E)),
            ("neg_log_temp", nlt, ()))),
        "on_device, library, loss view, counter": lambda: (
            _build.on_device(img.get_device()), _build.library(),
            loss4[0], setattr(I.fused_infonce_with_metrics, "launches",
                              I.fused_infonce_with_metrics.launches + 1)),
        "current stream and sync words": lambda: _build.sync_words(
            "infonce", 4),
        "9 data_ptr calls": lambda: [t.data_ptr() for t in (
            img, txt, nlt, out, loss4, lse_i, lse_t, metrics, bar)],
    }
    # the cooperative launches alone: K4's grid path (B = 1024) and K9
    B2 = 1024
    x2 = torch.randn(2, B2, E, generator=gen)
    img2, txt2 = (t.contiguous() for t in
                  C.l2_normalize(x2, dim=-1).cuda().unbind(0))
    out2 = torch.empty(2 * B2 + 8, device="cuda")
    part2 = torch.empty(6 * 16 * B2 + B2 + 6 * 256, device="cuda")
    o2 = out2.split((B2, B2, 4, 4))
    ptrs2 = [t.data_ptr() for t in (img2, txt2, nlt, part2, o2[2], o2[0],
                                    o2[1], o2[3], bar)]
    parts["the ctypes call alone, B = 1024 (cooperative launch)"] = (
        lambda: lib.mmb_infonce_fwd_f32(*ptrs2, B2, E, stream))
    args = C.lstm_case(gen, C.BATCH, C.MAX_LEN_UTTERANCE, C.LSTM_H)[0]
    L, H = C.MAX_LEN_UTTERANCE, C.LSTM_H
    kbuf = torch.empty((L + 4, B, H), device="cuda")
    _, ksync = _build.sync_words("lstm", 32 + 4 * 32)
    kptrs = [t.data_ptr() for t in (*args, kbuf[:L], kbuf[L], kbuf[L + 1],
                                    kbuf[L + 2:], ksync)]
    parts["K9's ctypes call alone (cooperative launch), L = 25"] = (
        lambda: lib.mmb_lstm_f32(*kptrs, L, B, H, stream))
    parts["K9's wrapper (lstm_fused), L = 25"] = (
        lambda: C.lstm_fused(*args))
    for what, fn in parts.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"  host: {what}: {us:.2f} us a call", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="the checkout whose lstm.cu the timeline probes")
    ap.add_argument("--skip-calls", action="store_true",
                    help="only the timeline")
    ap.add_argument("--variants", action="store_true",
                    help="also builds with the mma, the split or the "
                    "products taken out (the tensor-core design)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_recurrent: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.card_line(), flush=True)
    _build.library()
    if not args.skip_calls:
        print("per call: event time and profiler device time", flush=True)
        per_call()
        host_parts()
    design, lib = build_timeline(args.tree.resolve())
    print(f"K9 timeline of {args.tree.resolve()} ({design} design)",
          flush=True)
    for L in (C.MAX_LEN_UTTERANCE, C.LM_LEN):
        timeline(design, lib, L)
    if args.variants and design == "mma":
        for name, subs in VARIANTS.items():
            _, lib = build_timeline(args.tree.resolve(),
                                    name.replace(" ", "_"), subs)
            timeline(design, lib, C.MAX_LEN_UTTERANCE, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
