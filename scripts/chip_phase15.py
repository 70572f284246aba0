#!/usr/bin/env python3
"""The CLIP baseline of ``chip_smoke.py`` alone: phase 15 (K5 and K6 at the
CLIP towers' shapes, the ViT-L/14 forced choice and the ViT-B/16
eval-frame filter).

Builds the kernels and runs ``chip_smoke.phase_clip`` with its gates. Run
from the root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/chip_phase15.py

It exits non-zero when a gate fails, and prints "PHASE 15 OK" last.
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
        print("chip_phase15: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 15: the CLIP baseline", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_clip(Path(tmp), card)
    print("PHASE 15 OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
