#!/bin/bash
# Times K2, K3a and K3b in two checkouts of the repository on one card, in
# turns A, B, B, A: chip_smoke.py's phase 2c at the published plan's shapes
# (B = 128; K2 on layer3.0 only), each checkout building its own kernels.
# Prints the card's name and power limit, then each turn's registers and
# spills of the stage kernels and its times. Run from anywhere on a machine
# with an NVIDIA GPU:
#
#   bash scripts/ab_stage_kernel.sh <checkout A> <checkout B>
set -euo pipefail
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for dir in "$a" "$b" "$b" "$a"; do
  echo "== $dir"
  (cd "$dir" && python3 - <<'EOF'
import torch

import chip_smoke
from multimodal_baby_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.library()
lines = _build.build_log.splitlines()
for i, line in enumerate(lines):
    if "Function properties for" in line and ("stage_kernel" in line
                                              or "stage_tile_kernel" in line):
        print(" ", line.split("for ")[-1][-40:], "|",
              lines[i + 1].strip(), "|", lines[i + 2].split(": ", 1)[-1])
chip_smoke.Q_BLOCKS_EDGE = []
chip_smoke.STAGES_EDGE = []
chip_smoke.Q_BLOCKS_224 = chip_smoke.Q_BLOCKS_224[:1]
chip_smoke.phase_int8_and_stages()
EOF
  ) | grep -E "stage_kernel|stage_tile_kernel|B=128"
done
