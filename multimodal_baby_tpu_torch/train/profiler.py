"""Profiling and step timing (counterpart of
``multimodal_baby_tpu/train/profiler.py``).

- ``StepTimer``: wall-clock time per step with warmup exclusion and
  throughput; the clock is read after the device has finished the step.
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace.
- ``log_compile_time``: a first call (which builds the kernels it launches
  the first time) against a second one.
- ``device_memory_stats``: the CUDA caching allocator's bytes per device.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def synchronize(on=None) -> None:
    """Wait for the CUDA device of ``on`` (a tensor, a device, or a nested
    structure of tensors); nothing for the CPU."""
    if isinstance(on, dict):
        on = list(on.values())
    if isinstance(on, (list, tuple)):
        for x in on:
            synchronize(x)
        return
    device = on.device if isinstance(on, torch.Tensor) else on
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates per-step wall times; report() gives p50/p90/mean and
    items/sec."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._n_seen = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        """``sync_on``: what the step ran on (a tensor or a device); the
        clock is read after ``torch.cuda.synchronize`` on a CUDA one."""
        synchronize(sync_on)
        dt = time.perf_counter() - self._t0
        self._n_seen += 1
        if self._n_seen > self.warmup:
            self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        """``with timer.step() as out: ...; out["sync"] = result``."""
        self.start()
        out = {}
        yield out
        self.stop(out.get("sync"))

    def report(self, items_per_step: Optional[int] = None
               ) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        rep = {
            "steps_timed": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "total_s": float(t.sum()),
        }
        if items_per_step:
            rep["items_per_sec"] = items_per_step / rep["mean_s"]
        return rep


@contextlib.contextmanager
def trace(log_dir: str = "traces"):
    """Profile the block's host and CUDA activity with ``torch.profiler``
    and write it to ``log_dir/trace.json`` (Chrome / Perfetto format).
    Yields the profiler (``key_averages()`` tabulates it)."""
    from torch.profiler import ProfilerActivity, profile
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def log_compile_time(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Time a first call of ``fn`` (which builds and loads the kernels it
    launches the first time) against a second, each to the end of its
    device work."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(out)
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(out)
    execute_s = time.perf_counter() - t0
    return {"first_call_s": first_s, "steady_state_s": execute_s,
            "compile_overhead_s": first_s - execute_s}


def device_memory_stats() -> List[Dict[str, float]]:
    """Per CUDA device: bytes the caching allocator holds for tensors now
    and at their peak (``torch.cuda.memory_stats``), and the card's
    memory; empty without CUDA."""
    stats = []
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats.append({
            "device": f"cuda:{i}",
            "bytes_in_use": m.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": m.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return stats
