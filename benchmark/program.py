"""The program under test as the benchmark drives it: the model built
through ``multimodal_baby_tpu_torch``'s entry point with the benchmark's
seeded weights loaded, and the host batches of a traffic mix. This module
and the loops are the only ones here that import the program."""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import sub_seed

SOS, EOS = 2, 3
FIRST_WORD = 4   # ids 0-3: padding, unknown, start, end


def experiment(cfg: dict, traffic: dict, seed: int):
    """The recipe's ``ExperimentConfig`` at the mix's batch, with the
    optimizer of the configuration and the run's generator seed."""
    from multimodal_baby_tpu_torch.core.config import ExperimentConfig
    d = copy.deepcopy(cfg["experiment"])
    d["data"]["batch_size"] = traffic["batch"]
    d["train"]["lr"] = cfg["optimizer"]["lr"]
    d["train"]["weight_decay"] = cfg["optimizer"]["weight_decay"]
    d["train"]["seed"] = sub_seed(seed, "generator")
    return ExperimentConfig.from_dict(d)


def build_model(exp, weights: Dict[str, torch.Tensor], device):
    """``CVCL`` in the configuration's compute dtype with the default kernel
    configuration, every leaf then set to the benchmark's weights."""
    from multimodal_baby_tpu_torch.models.multimodal import CVCL
    from benchmark.reference.weights import check_names
    dtype = (torch.bfloat16 if exp.parallel.compute_dtype == "bfloat16"
             else torch.float32)
    model = CVCL(exp.model, dtype=dtype, device=device,
                 generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    check_names([(n, tuple(t.shape), None) for n, t in weights.items()],
                {n: t.shape for n, t in sd.items()})
    model.load_state_dict(weights, strict=True)
    return model


def frame_pool(traffic: dict, seed: int, device) -> List[np.ndarray]:
    """``pool_batches`` batches of uniform uint8 frames, drawn on the device
    from the seed in one call and handed to the host."""
    n, b, px = traffic["pool_batches"], traffic["batch"], traffic["frame_px"]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "frames"))
    frames = torch.randint(0, 256, (n * b, px, px, 3), dtype=torch.uint8,
                           generator=gen, device=device).cpu().numpy()
    return [frames[i * b:(i + 1) * b] for i in range(n)]


def utterances(n: int, words, vocab: int, max_len: int, seed: int):
    """(ids [n, max_len] int32, lengths [n] int32): start, 1 to 23 words
    uniform over the vocabulary's words, end, padding."""
    rng = np.random.default_rng(sub_seed(seed, "utterances"))
    k = rng.integers(words[0], words[1] + 1, size=n)
    ids = rng.integers(FIRST_WORD, vocab, size=(n, max_len), dtype=np.int64)
    pos = np.arange(max_len)[None, :]
    text = np.where((pos >= 1) & (pos <= k[:, None]), ids, 0)
    text[:, 0] = SOS
    text[np.arange(n), k + 1] = EOS
    return text.astype(np.int32), (k + 2).astype(np.int32)


def train_pool(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """The loader's batches: frames, token ids and lengths as numpy."""
    frames = frame_pool(traffic, seed, device)
    b = traffic["batch"]
    s = cfg["sizes"]
    text, lens = utterances(len(frames) * b, traffic["words"],
                            s["vocab_size"], s["max_len"], seed)
    return [{"image_u8": f, "text": text[i * b:(i + 1) * b],
             "text_len": lens[i * b:(i + 1) * b]}
            for i, f in enumerate(frames)]


class Clock:
    """Marks on the device's stream (CUDA events, no host sync) or, on the
    CPU, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        import time
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


class TrunkSpans:
    """Marks on the stream before and after each call of the trunk's
    forward, from hooks the benchmark puts on ``model.vision_encoder.model``
    (the program is not edited); recorded only while ``on``."""

    def __init__(self, model, clock: Clock):
        self.clock, self.on, self.marks = clock, False, []
        trunk = model.vision_encoder.model
        self._hooks = [trunk.register_forward_pre_hook(self._pre),
                       trunk.register_forward_hook(self._post)]

    def _pre(self, module, args):
        if self.on:
            self._start = self.clock.mark()

    def _post(self, module, args, out):
        if self.on:
            self.marks.append((self._start, self.clock.mark()))

    def ms(self) -> List[float]:
        return [self.clock.ms(a, b) for a, b in self.marks]

    def remove(self):
        for h in self._hooks:
            h.remove()
