#!/usr/bin/env python3
"""The port's real-input training throughput: on-disk JPEGs -> the native
decoder -> pinned copies to the card -> the published recipe's train step
(counterpart of ``bench.py --real_io``, ``bench.py:316-410``).

The data is ``bench.py::ensure_jpeg_dataset``'s synthetic JPEG set (low-
frequency noise, 256 px, quality 90, one utterance of 2-11 made-up words
per frame), written under a temporary directory. The run:
``PairedImageTextDataset`` -> ``DataLoader(num_workers=4, prefetch=6)``
-> ``train/step.py::device_batch`` through a ``HostStaging`` ring -> the
published recipe's train step (``configs/_base.py``'s flags with
``--frozen_bn running --trunk_int8 0,0,1,1``: int8 layers 3-4 on K3b, K1,
K2 and K3a, calibrated once) at B = 128, seeded random weights. The host
never waits for the card inside the loop. 4 warm batches, then 24 timed
ones; then a probe of the copy of one batch's frames to the card, from
pageable and from pinned memory. Prints one JSON line of results, with
the card's name and power limit. Run from the root of the repository:

    python3 scripts/real_io_torch.py [--jpegs 1024] [--batch 128]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_baby_tpu_torch.cli.args import (  # noqa: E402
    add_all_args, args_to_config)
from multimodal_baby_tpu_torch.data import native  # noqa: E402
from multimodal_baby_tpu_torch.data.datasets import (  # noqa: E402
    PairedImageTextDataset, load_metadata)
from multimodal_baby_tpu_torch.data.loader import DataLoader  # noqa: E402
from multimodal_baby_tpu_torch.data.vocab import Vocab  # noqa: E402
from multimodal_baby_tpu_torch.models.multimodal import CVCL  # noqa: E402
from multimodal_baby_tpu_torch.ops.bottleneck import (  # noqa: E402
    fused_bottleneck)
from multimodal_baby_tpu_torch.ops.stage import (  # noqa: E402
    fused_stage, fused_stage_banded)
from multimodal_baby_tpu_torch.train.step import (  # noqa: E402
    HostStaging, calibrate_trunk, device_batch, init_train_state,
    make_train_step)

# configs/_base.py's contrastive recipe with the published trunk plan
RECIPE_ARGV = [
    "--cnn_dino", "--frozen_bn", "running", "--trunk_int8", "0,0,1,1",
    "--text_encoder", "embedding", "--embedding_dim", "512",
    "--normalize_features", "--fix_temperature", "--temperature", "0.07",
    "--augment_frames", "--dropout_i", "0.5", "--optimizer", "AdamW",
    "--lr", "1e-4", "--weight_decay", "0.1", "--optimize_unused"]
# (K1, K2, K3a, K3b) launch counters
COUNTERS = [(fused_bottleneck, "launches"), (fused_bottleneck, "launches_q"),
            (fused_stage, "launches"), (fused_stage_banded, "launches")]
WARM, TIMED = 4, 24


def write_jpeg_dataset(root, n: int, src: int = 256, seed: int = 0) -> Path:
    """``bench.py::ensure_jpeg_dataset``'s frames and metadata under
    ``root``: n JPEGs of src px, each low-frequency noise (a 16 x 16 random
    image, bilinear-resized, plus noise in [-12, 12]) saved at quality 90,
    with an utterance of 2-11 words "wNNNN". Returns the metadata path."""
    from PIL import Image
    root = Path(root)
    (root / "frames").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        low = rng.randint(0, 256, (16, 16, 3), np.uint8)
        img = np.asarray(
            Image.fromarray(low).resize((src, src), Image.BILINEAR))
        img = np.clip(img.astype(np.int16)
                      + rng.randint(-12, 13, img.shape, np.int16),
                      0, 255).astype(np.uint8)
        path = root / "frames" / f"frame_{i:05d}.jpg"
        Image.fromarray(img).save(path, quality=90)
        n_words = int(rng.randint(2, 12))
        utterance = " ".join(
            f"w{rng.randint(0, 2000):04d}" for _ in range(n_words))
        records.append({"utterance": utterance,
                        "frame_filename": str(path)})
    meta = root / "metadata.json"
    meta.write_text(json.dumps({"data": records}))
    return meta


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def h2d_rates(frames: np.ndarray, device, reps: int = 4):
    """MB/s of copying ``frames`` to ``device``: from pageable memory (a
    blocking copy) and from a pinned buffer (non-blocking copies), each
    ``reps`` times after one warm copy, ended by a synchronization."""
    pageable = torch.from_numpy(np.ascontiguousarray(frames))
    pinned = pageable.pin_memory()
    rates = {}
    for name, src, kw in (("pageable", pageable, {}),
                          ("pinned", pinned, {"non_blocking": True})):
        src.to(device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            src.to(device, **kw)
        torch.cuda.synchronize()
        rates[name] = reps * frames.nbytes / (time.perf_counter() - t0) / 1e6
    return rates


def run(root, n_jpegs: int = 1024, batch_size: int = 128, device="cuda",
        workers: int = 4, warm: int = WARM, timed: int = TIMED) -> dict:
    """Write the JPEG set under ``root``, train the published recipe on it
    and return the measurements: pairs/s over the timed batches, the
    loader's wait and the host's staging time in that window, the launches
    of K1, K2, K3a and K3b in each step, the losses, and the H2D rates."""
    data = load_metadata(write_jpeg_dataset(root, n_jpegs))
    vocab = Vocab.build([d["utterance"] for d in data], min_freq=1)
    dataset = PairedImageTextDataset(data, vocab)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        drop_last=True, num_workers=workers, prefetch=6)
    parser = argparse.ArgumentParser()
    add_all_args(parser)
    cfg = args_to_config(parser.parse_args(
        RECIPE_ARGV + ["--batch_size", str(batch_size)]))
    cfg.model.vocab_size = len(vocab)
    model = CVCL(cfg.model, torch.bfloat16, device=device,
                 generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg)
    staging = HostStaging()
    first = next(iter(loader))
    calibrate_trunk(model, device_batch(first, device, staging))
    train_step = make_train_step(model, cfg)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def feed(n):
        it, out = iter(loader), {"launches": [], "loss": [], "wait_s": 0.0,
                                 "stage_s": 0.0}
        sync()
        t0 = time.perf_counter()
        while len(out["loss"]) < n:
            t = time.perf_counter()
            batch = next(it, None)
            out["wait_s"] += time.perf_counter() - t
            if batch is None:
                it = iter(loader)
                continue
            t = time.perf_counter()
            dev = device_batch(batch, device, staging)
            out["stage_s"] += time.perf_counter() - t
            before = [getattr(fn, a) for fn, a in COUNTERS]
            out["loss"].append(train_step(state, dev)["loss"])
            out["launches"].append([getattr(fn, a) - b for (fn, a), b
                                    in zip(COUNTERS, before)])
        sync()
        out["seconds"] = time.perf_counter() - t0
        out["loss"] = [float(v) for v in out["loss"]]
        return out

    feed(warm)
    res = feed(timed)
    res.update(pairs_per_s=timed * batch_size / res["seconds"],
               batch=batch_size, jpegs=n_jpegs, workers=workers,
               decoder="native" if native.available()
               else f"pil ({native.build_error()})",
               device=str(torch.device(device)))
    if torch.device(device).type == "cuda":
        res["h2d_mb_s"] = h2d_rates(first["image_u8"], device)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jpegs", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("real_io_torch: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        res = run(tmp, args.jpegs, args.batch, args.device)
    if not all(math.isfinite(v) for v in res["loss"]):
        print(f"real_io_torch: losses {res['loss']}", file=sys.stderr)
        return 1
    if torch.device(args.device).type == "cuda":
        res["card"] = card_line()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
