#!/usr/bin/env python3
"""Where K10b's time goes (``fused_bottleneck_tiles``,
csrc/bottleneck_fused.cu): the kernel timed at layer 2's head of a B = 128
forward (56 x 56 x 256 -> 28 x 28 x 512, width 256, stride 2, downsample)
beside probe builds of the same source with one part changed:

- ``no_phase1``, ``no_phase2``, ``no_phase3``: that phase skipped;
- ``no_mma``: the two 1x1 phases stream their slices through the ring but
  compute nothing (copies, barriers and the grouped 3x3 remain);
- ``no_copies``: the ring issues no copies (products on stale slices);
- ``no_epi1``, ``no_epi3``: conv1's or conv3's epilogue stores nothing;
- ``no_w2_loads``: the grouped 3x3 builds its weight fragments from a
  constant instead of loading them;
- ``stages3``: a three-stage ring (copies one slice ahead instead of two;
  its shared memory placed by ``tiles_geometry``'s rule).

A probe that changes nothing but the ring's depth is compared with K1
(``fused_bottleneck``: the outputs that differ and by how many bf16 ulps);
the others compute garbage and are only timed. Each probe is
``bottleneck_fused.cu`` compiled alone with nvcc into
``build/probe_tiles/`` (git-ignored), the builds in parallel; the times are
taken in turns (all, then all again), K1 and cuDNN's block beside them.
Needs an NVIDIA H100 and the CUDA toolkit:

    python3 scripts/probe_tiles.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402
from multimodal_baby_tpu_torch.ops import bottleneck as TB  # noqa: E402

B, H, CIN, WIDTH, COUT, STRIDE = 128, 56, 256, 256, 512, 2
OUT = ROOT / "build" / "probe_tiles"
PHASE1 = "      (P1 + FB_BM - 1) / FB_BM, (width + FB_BN - 1) / FB_BN,"
PHASE3 = "      (M + FB_BM - 1) / FB_BM, (p.cout + FB_BN - 1) / FB_BN, nk,"
PHASE2 = "    for (int cb = warp; cb < width / 16; cb += FB_THREADS / 32) {"
COMPUTE = "    if (pn * FB_BN + wg * 128 >= n_valid) continue;"
ISSUE = "    if (i < steps) {"
STAGES = "constexpr int FB_STAGES = 4;"
EPI1 = "          if (m >= P1) continue;"
EPI3 = "          const bool ok = m < M;"
W2 = "? w2[(tap * CG + ci % CG) * width + co]"
# probe -> ([(text in bottleneck_fused.cu, its replacement)], ring stages)
PROBES = {
    "kernel": ([], 4),
    "no_phase1": ([(PHASE1, PHASE1.replace("(P1", "0 * (P1"))], 4),
    "no_phase2": ([(PHASE2, PHASE2.replace("= warp;", "= width;"))], 4),
    "no_phase3": ([(PHASE3, PHASE3.replace("(M +", "0 * (M +"))], 4),
    "no_mma": ([(COMPUTE, COMPUTE.replace(">= n_valid)",
                                          ">= n_valid || steps > 0)"))], 4),
    "no_copies": ([(ISSUE, ISSUE.replace("i < steps", "i < 0"))], 4),
    "stages3": ([(STAGES, STAGES.replace("4", "3"))], 3),
    "no_epi1": ([(EPI1, EPI1.replace("m >= P1", "m >= 0"))], 4),
    "no_epi3": ([(EPI3, EPI3.replace("m < M", "m < 0"))], 4),
    "no_w2_loads": ([(W2, "? 0x3f80u + 0u * co")], 4),
}
EXACT = ("kernel", "stages3")


def build(name: str, edits) -> subprocess.Popen:
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    text = (src / "bottleneck_fused.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"probe {name}: the source no longer holds "
                               f"{old!r}")
        text = text.replace(old, new)
    (src / "bottleneck_fused.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS, "-o",
         str(src / "lib.so"), str(src / "bottleneck_fused.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def geometry(stages: int):
    """tiles_geometry with rings of ``stages`` stages."""
    saved = TB.FUSED_STAGES
    TB.FUSED_STAGES = stages
    try:
        return TB.tiles_geometry(H, H, CIN, WIDTH, COUT, STRIDE, True)
    finally:
        TB.FUSED_STAGES = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tiles: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    procs = {name: build(name, edits) for name, (edits, _) in PROBES.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"probe {name}: nvcc failed")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.mmb_bottleneck_fused_bf16.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        libs[name] = lib

    x, fw = chip_smoke.random_block(torch.Generator().manual_seed(0), H, CIN,
                                    WIDTH, COUT, STRIDE, True, B)
    Ho = (H - 1) // STRIDE + 1
    y = torch.empty((B, Ho, Ho, COUT), dtype=x.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    weights = [fw[k].data_ptr() for k in TB._BF16_ORDER]

    def run(name):
        geo = geometry(PROBES[name][1])
        code = libs[name].mmb_bottleneck_fused_bf16(
            x.data_ptr(), *weights, y.data_ptr(), B, H, H, CIN, WIDTH, COUT,
            STRIDE, geo.R, *geo[2:], stream)
        if code:
            raise RuntimeError(f"probe {name}: CUDA error {code}")

    k1 = TB.fused_bottleneck(x, fw, stride=STRIDE)
    for name in EXACT:
        run(name)
        torch.cuda.synchronize()
        ulps = (y.view(torch.int16).int() - k1.view(torch.int16).int()).abs()
        print(f"{name}: {geometry(PROBES[name][1])}; "
              f"{int((ulps > 0).sum())} outputs differ from K1, by at most "
              f"{int(ulps.max())} bf16 ulps")
    print(chip_smoke.card_line())
    lib_chain = chip_smoke.conv_chain(fw, STRIDE)
    fns = {name: (lambda n=name: run(n)) for name in libs}
    fns["K1"] = lambda: TB.fused_bottleneck(x, fw, stride=STRIDE)
    fns["cuDNN"] = lambda: lib_chain(x)
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(chip_smoke.time_ms(fn, 20))
    for name, ts in times.items():
        print(f"{name:10s} {' / '.join(f'{t:.4f}' for t in ts)} ms (B={B}, "
              f"layer 2's head, per call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
