#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone: text generation, grad-CAM and the
analyses that run a model, on the published trunk's kernels.

Builds the kernels, then runs the phases phase 11 reads: phase 5 (the
published int8 trunk, calibrated), phase 7 (the LSTM recipes; 11e takes
7b's joint model) and phase 9's least-squares head fit on the published
model, then ``chip_smoke.phase_analyses`` with its gates. Run from the
root of the repository on a machine with an NVIDIA GPU:

    python3 scripts/chip_phase11.py

It exits non-zero when a gate fails, and prints "PHASE 11 OK" last.
"""

import sys
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
        print("chip_phase11: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    _, published, _ = cs.phase_published_flagship()
    _, joint = cs.phase_lstm_slice()
    frames, cats = cs.eval_frames(np.random.RandomState(9), 4)
    cs.fit_head(published[0].model, frames, cats,
                Vocab.load(cs.PACKAGED_VOCAB))
    cs.phase_analyses(published, joint, card)
    print("PHASE 11 OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
