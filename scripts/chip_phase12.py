#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: the host input path (the native
decoder and the pinned copies), the host-only analysis chain and the sweep
runner, on the published trunk's kernels.

Builds the kernels, then runs the phases phase 12 reads: phase 5 (the
published int8 trunk, calibrated) with phase 9's least-squares head fit
on it, and phase 10 (the trainer's checkpoint root and 10c's SAYCam-format
directory), then ``chip_smoke.phase_host_input`` with its gates. Run from
the root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/chip_phase12.py

It exits non-zero when a gate fails, and prints "PHASE 12 OK" last.
"""

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from multimodal_baby_tpu_torch.data.vocab import Vocab  # noqa: E402
from multimodal_baby_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase12: torch.cuda.is_available() is false",
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
    frames, cats = cs.eval_frames(np.random.RandomState(9), 4)
    cs.fit_head(published[0].model, frames, cats,
                Vocab.load(cs.PACKAGED_VOCAB))
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_trainer(card, step_s, Path(tmp))
        cs.phase_host_input(Path(tmp), published, card)
    print("PHASE 12 OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
