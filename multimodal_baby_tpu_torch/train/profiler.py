"""Profiling and step timing (counterpart of
``multimodal_baby_tpu/train/profiler.py``).

- ``StepTimer``: wall-clock time per step with warmup exclusion and
  throughput; the clock is read after the device has finished the step.
- ``span`` and ``wait``: the program's own ranges at its layer
  boundaries, recorded into ``SPANS`` only while a ``torch.profiler``
  session records (below).
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace
  that holds the program's spans beside every kernel and copy.
- ``device_memory_stats``: the CUDA caching allocator's bytes per device.

**Spans.** ``with span("augment"):`` marks a layer, ``with
wait("staging_slot"):`` a place where the host blocks on the card. With
no profiler session open each is one check of the profiler's flag and a
shared no-op context. While one records, each opens a profiler range
named ``mmb/<name>`` (a wait ``mmb/wait/<name>``), so it lies on the
profiler's clock beside the kernels it launched, and ``SPANS`` keeps its
name, parent, root, host
start and end (``perf_counter_ns``) and a pair of CUDA events on the
current stream (on the CPU, device time is host time). The range is
``record_function``'s, recorded as a CPU operation
(``torch._C._profiler._RecordFunctionFast``): as a user annotation the
profiler would also copy it onto the device's timeline, where a trace
reader counts it as a device operation. A span opened
with none open is a root: a train step, a ``device_batch``, a chunk of
``extract_features``. Nothing syncs the host while spans record; event
times are read when ``SPANS.table()`` or ``SPANS.summary()`` is called,
after the block's own synchronize.

Each root that records on the card also turns on
``torch.cuda.set_sync_debug_mode("warn")`` and counts every
synchronizing call in the innermost open span, so a host wait that no
``wait`` covers shows as a count; the mode, the warning filters and
``warnings.showwarning`` are restored when the root ends.

Each thread keeps its own stack of open spans. A span that another
thread opens while a root is open, with none of its own open, is kept
under the innermost span open on the root's thread: autograd runs a CUDA
backward on its own device thread while the calling thread waits inside
``mmb/backward``, so the spans of the backward (``ops/vit_common.py::
PlainVJP``: ``mmb/vjp/<kernel>``) nest there.

``SPANS`` holds the latest profiled block only: the first recording root
after a span that did not record starts it afresh, as ``trace`` does. It
keeps at most ``MAX_SPANS`` spans; a root that does not fit is dropped
whole, with the rest of the block.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


PREFIX = "mmb/"
WAIT_PREFIX = PREFIX + "wait/"
MAX_SPANS = 1 << 15
# the warning of torch.cuda.set_sync_debug_mode("warn")
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span:
    """One recorded span: ``parent`` and ``root`` are indices into
    ``SpanStore.spans`` (``parent`` None for a root), ``t0``/``t1`` host
    ns, ``e0``/``e1`` its CUDA events (None where the root began with CUDA
    uninitialised), ``syncs`` the synchronizing calls counted while it was
    the innermost open span (None where the root counted none)."""

    __slots__ = ("name", "index", "parent", "root", "t0", "t1", "e0", "e1",
                 "syncs")

    def __init__(self, name: str, index: int, parent: Optional[int],
                 root: int, cuda: bool):
        self.name, self.index, self.parent, self.root = (name, index, parent,
                                                         root)
        self.t1 = None
        self.syncs = 0 if cuda else None
        if cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
        else:
            self.e0 = self.e1 = None


class _Recording:
    """The context of one span while a profiler session records."""

    __slots__ = ("store", "name", "span", "range")

    def __init__(self, store: "SpanStore", name: str):
        self.store, self.name = store, name

    def __enter__(self):
        self.store._enter(self)
        return self

    def __exit__(self, *exc):
        self.store._exit(self, exc)
        return False


class SpanStore:
    """The spans of the latest profiled block (the module's docstring)."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.stale = True   # a span ran unrecorded: the next root resets
        self._local = threading.local()   # .stack: this thread's open spans
        # the stack of the thread whose root is open (None between roots)
        self._root_stack: Optional[List[Optional[Span]]] = None
        self._sync_mode = self._warnings = self._showwarning = None
        self.reset()

    def reset(self) -> None:
        """Forget every span; the next recording root starts the block."""
        self.spans: List[Span] = []
        self.dropped_roots = 0
        self.stale = False
        self._full = False

    # -- recording ------------------------------------------------------

    def _thread_stack(self) -> List[Optional[Span]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _enter(self, rec: _Recording) -> None:
        stack = self._thread_stack()
        # the open spans above this one: this thread's, else the open
        # root's thread's
        above = stack or self._root_stack
        if not above:
            self._begin_root()
            self._root_stack = stack
        rec.range = torch._C._profiler._RecordFunctionFast(rec.name)
        rec.range.__enter__()
        rec.span = span_ = None
        if not self._full and (not above or above[-1] is not None):
            if len(self.spans) >= self.limit:
                # the open root does not fit: drop it whole
                del self.spans[self._root_start:]
                self._full = True
                self.dropped_roots += 1
            else:
                i = len(self.spans)
                parent = above[-1] if above else None
                span_ = Span(rec.name, i,
                             None if parent is None else parent.index,
                             i if parent is None else parent.root,
                             self._cuda)
                self.spans.append(span_)
                rec.span = span_
        stack.append(span_)
        if span_ is not None:
            span_.t0 = time.perf_counter_ns()
            if span_.e0 is not None:
                self._record(span_.e0)

    def _exit(self, rec: _Recording, exc) -> None:
        span_ = rec.span
        stack = self._thread_stack()
        if span_ is not None:
            if span_.e1 is not None:
                self._record(span_.e1)
            span_.t1 = time.perf_counter_ns()
        stack.pop()
        rec.range.__exit__(*exc)
        if not stack and stack is self._root_stack:
            self._root_stack = None
            self._end_root()

    def _record(self, event) -> None:
        """``event.record()`` on the current stream; the stream object is
        kept while the current stream stays the same (fetching it costs
        twice the record on the card)."""
        raw = torch._C._cuda_getCurrentRawStream(self._stream.device_index)
        if raw != self._stream.cuda_stream:
            self._stream = torch.cuda.current_stream()
        event.record(self._stream)

    def _begin_root(self) -> None:
        if self.stale:
            self.reset()
        if self._full:
            self.dropped_roots += 1
        self._root_start = len(self.spans)
        self._cuda = torch.cuda.is_initialized()
        if self._cuda:
            self._stream = torch.cuda.current_stream()
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self._showwarning = warnings.showwarning
            warnings.showwarning = self._warned
            torch.cuda.set_sync_debug_mode("warn")

    def _end_root(self) -> None:
        if self._warnings is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._warnings.__exit__(None, None, None)
            self._warnings = self._showwarning = None

    def _warned(self, message, category, filename, lineno, file=None,
                line=None):
        if str(message).startswith(SYNC_WARNING):
            stack = self._thread_stack() or self._root_stack
            if stack and stack[-1] is not None:
                stack[-1].syncs += 1
            return
        self._showwarning(message, category, filename, lineno, file, line)

    # -- reading (after the block's own synchronize) --------------------

    def table(self) -> List[Dict]:
        """Every kept span: name, parent and root (indices into this list),
        wait (a ``wait`` span), host_ms, device_ms (its CUDA events, else
        host ms) and syncs; an open span's times are None."""
        if any(s.e1 is not None and s.t1 is not None for s in self.spans):
            torch.cuda.synchronize()
        rows = []
        for s in self.spans:
            host = None if s.t1 is None else (s.t1 - s.t0) / 1e6
            dev = host
            if host is not None and s.e0 is not None:
                dev = s.e0.elapsed_time(s.e1)
            rows.append({"name": s.name, "parent": s.parent, "root": s.root,
                         "wait": s.name.startswith(WAIT_PREFIX),
                         "host_ms": host, "device_ms": dev,
                         "syncs": s.syncs})
        return rows

    def summary(self, per: str) -> Optional[Dict]:
        """The block's closed roots, per root named ``per`` (e.g.
        ``"mmb/train_step"``): ``steps``, the number of those roots;
        ``device_ms``, ``self_ms`` and ``span_host_ms`` by span name, each
        name's spans summed (``self_ms``: device ms less their direct
        children's; ``span_host_ms``: host ms);
        ``host_ms``, the host time of every root less the outermost
        ``wait`` spans in them; ``waits``, the ``wait`` spans;
        ``unwaited_syncs``, synchronizing calls counted outside any
        ``wait``; ``syncs``, the two together (both None where the block
        counted no syncs: the CPU). None when no such root closed."""
        rows = self.table()
        closed = {i for i, r in enumerate(rows)
                  if r["parent"] is None and r["host_ms"] is not None}
        steps = sum(rows[i]["name"] == per for i in closed)
        if not steps:
            return None
        device: Dict[str, float] = {}
        own: Dict[str, float] = {}
        span_host: Dict[str, float] = {}
        in_wait = [False] * len(rows)
        host = waits = 0.0
        unwaited: Optional[int] = 0
        for i, r in enumerate(rows):
            if r["root"] not in closed:
                continue
            p = r["parent"]
            in_wait[i] = r["wait"] or (p is not None and in_wait[p])
            device[r["name"]] = device.get(r["name"], 0.0) + r["device_ms"]
            own[r["name"]] = own.get(r["name"], 0.0) + r["device_ms"]
            span_host[r["name"]] = (span_host.get(r["name"], 0.0)
                                    + r["host_ms"])
            if p is None:
                host += r["host_ms"]
            else:
                own[rows[p]["name"]] -= r["device_ms"]
            if r["wait"]:
                waits += 1
                if p is None or not in_wait[p]:
                    host -= r["host_ms"]
            if r["syncs"] is None:
                unwaited = None
            elif unwaited is not None and not in_wait[i]:
                unwaited += r["syncs"]
        out = {"steps": steps,
               "device_ms": {k: v / steps for k, v in device.items()},
               "self_ms": {k: v / steps for k, v in own.items()},
               "span_host_ms": {k: v / steps for k, v in span_host.items()},
               "host_ms": host / steps, "waits": waits / steps,
               "unwaited_syncs": None, "syncs": None}
        if unwaited is not None:
            out["unwaited_syncs"] = unwaited / steps
            out["syncs"] = (waits + unwaited) / steps
        return out


SPANS = SpanStore()
_OFF = contextlib.nullcontext()


def span(name: str):
    """The program span ``mmb/<name>`` around a ``with`` block: recorded
    into ``SPANS`` while a ``torch.profiler`` session records, else a
    shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        SPANS.stale = True
        return _OFF
    return _Recording(SPANS, PREFIX + name)


def wait(name: str):
    """As ``span``, named ``mmb/wait/<name>``: a place where the host
    blocks until the card has run what is queued."""
    if not _autograd_profiler._is_profiler_enabled:
        SPANS.stale = True
        return _OFF
    return _Recording(SPANS, WAIT_PREFIX + name)


@contextlib.contextmanager
def trace(log_dir: str = "traces"):
    """Profile the block's host and CUDA activity with ``torch.profiler``
    and write it to ``log_dir/trace.json`` (Chrome / Perfetto format), the
    program's ``mmb/`` spans among its ranges. Yields the profiler
    (``key_averages()`` tabulates it); ``SPANS`` holds the block's spans
    afterwards."""
    from torch.profiler import ProfilerActivity, profile
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    SPANS.reset()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


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
