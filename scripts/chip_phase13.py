#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: the offline ETL and COCO, local
backbone checkpoints and the distributed train step at world 1, on the
published trunk's kernels.

Builds the kernels, runs phase 5 (the published int8 trunk, calibrated:
phase 13c writes its trunk to a checkpoint and 13d times its step beside
phase 5's), then ``chip_smoke.phase_etl_coco_backbones_distributed`` with
its gates. Run from the root of the repository on a machine with an
NVIDIA GPU:

    python3 scripts/chip_phase13.py

It exits non-zero when a gate fails, and prints "PHASE 13 OK" last.
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
        print("chip_phase13: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    _, published, step_s = cs.phase_published_flagship()
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_etl_coco_backbones_distributed(Path(tmp), published, step_s,
                                                card)
    print("PHASE 13 OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
