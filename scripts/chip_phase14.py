#!/usr/bin/env python3
"""The opt-in modes of ``chip_smoke.py`` alone: phase 6 (the ViT's kernel
configurations, the int8 and LN-fold modes among them) and phase 14 (the
stems, the augment's forms, the differentiable K1 and the kernel flags of
``cli/train.py``).

Builds the kernels, runs phase 4 (the ViT slice, whose model phase 6
switches), phase 6, phase 5 (the published int8 trunk, calibrated, which
phase 14e switches between stems) and then
``chip_smoke.phase_opt_in_modes`` with its gates. Run from the root of
the repository on a machine with an NVIDIA GPU:

    python3 scripts/chip_phase14.py

It exits non-zero when a gate fails, and prints "PHASE 14 OK" last.
"""

import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase14: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 4: the ViT slice", flush=True)
    _, vit = cs.phase_vit_slice()
    print("phase 6: the ViT slice in its other kernel configurations",
          flush=True)
    print(cs.phase_vit_configs(*vit), flush=True)
    print("phase 5: the published flagship", flush=True)
    _, published, _ = cs.phase_published_flagship()
    print("phase 14: the opt-in modes", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_opt_in_modes(Path(tmp), published)
    print("PHASE 14 OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
