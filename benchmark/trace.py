"""The device timeline of a traced block of steps, from ``torch.profiler``
(CUPTI on the card): the union of kernel, copy and set intervals (so
overlapping work counts once), the block's span from its first device
operation to its last, host-to-device copy time, kernel launches, the
operations that took most time, and the longest idle gaps named by the
host operation in flight when each began."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def _kind(e) -> str:
    try:
        kind = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        kind = ""
    name = e.name()
    if "memcpy" in kind or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in kind or name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, gaps between covered stretches) of sorted intervals."""
    covered, gaps = 0, []
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            covered += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    covered += cur_e - cur_s
    return covered, gaps


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def read_profile(prof, steps: int) -> Dict:
    """Facts of a profiled block of ``steps`` steps; {} when the trace holds
    no device operation (a CPU run)."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                device.append(e)
        elif not e.name().startswith(("cuda", "cudaLaunch")):
            host.append(e)
    if not device:
        return {}
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in device)
    busy_ns, gaps = _union(iv)
    window_ns = iv[-1][1] - iv[0][0]
    by_name: Dict[str, int] = defaultdict(int)
    h2d_ns = kernels = 0
    for e in device:
        kind = _kind(e)
        by_name[e.name()] += e.duration_ns()
        if kind == "kernel":
            kernels += 1
        elif kind == "memcpy" and "HtoD" in e.name():
            h2d_ns += e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host_iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in host)
    named_gaps = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        doing = "no host operation (Python)"
        for s, e_, name in host_iv:
            if s > g0:
                break
            if e_ >= g0:
                doing = name   # the innermost op open at the gap's start
        named_gaps.append([_short(doing), (g1 - g0) / 1e9])
    return {
        "steps": steps,
        "busy_s": busy_ns / 1e9,
        "window_s": window_ns / 1e9,
        "h2d_s": h2d_ns / 1e9,
        "kernels": kernels,
        "device_ops": [[_short(n), ns / 1e9 / steps] for n, ns in top],
        "idle_gaps": named_gaps,
    }
