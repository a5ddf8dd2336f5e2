"""Tracing & profiling utilities (port of ``elimaloc_tpu/utils/timing.py``).

The reference instruments its hot path with chrono cout macros gated by
``debug_print`` (reference: localization_functions.hpp:70-76, used at
pcm_matching.cpp:213-323 and registration.cpp:307-403). Here: per-stage
timers, each stage a ``torch.profiler.record_function`` span that shows in
a :func:`device_trace`, and a per-stage dashboard. While CUDA is in use a
stage is timed by two CUDA events on the current stream (the stage's span
on the device's queue), read when the totals are; otherwise by the host
clock, as the JAX package's timers are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _cuda_devices(out, found=None):
    """The CUDA devices of the tensors in ``out`` (records, dicts and
    sequences walked)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif dataclasses.is_dataclass(out):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


class StageTimers:
    """Accumulates the time of named stages: CUDA-event time on the current
    stream while CUDA is in use, host wall-clock otherwise."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._pending = []   # (name, start event, end event) not read yet

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a block. ``sync`` (or :meth:`sync` called inside) waits for
        the device work that produced it before the block ends."""
        if not self.enabled:
            yield self
            return
        events = torch.cuda.is_available() and torch.cuda.is_initialized()
        if events:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield self
        if sync is not None:
            self.sync(sync)
        if events:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((name, start, end))
        else:
            self._totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def sync(self, out):
        """Wait for the CUDA work on ``out``'s devices; returns ``out``."""
        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        return out

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage (reads the pending CUDA events: waits for them)."""
        for name, start, end in self._pending:
            end.synchronize()
            self._totals[name] += start.elapsed_time(end) * 1e-3
        self._pending.clear()
        return self._totals

    def report(self) -> str:
        """Per-stage dashboard (the STOP_TIMER printout, aggregated)."""
        totals = self.totals
        lines = ["stage                      total_ms    calls   ms/call"]
        for name in sorted(totals, key=lambda n: -totals[n]):
            t, c = totals[name] * 1e3, self.counts[name]
            lines.append(f"{name:<26s} {t:9.2f} {c:8d} {t / max(c, 1):9.3f}")
        return "\n".join(lines)

    def reset(self):
        self._pending.clear()
        self._totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace (host, and the device while CUDA is
    available) around a block, written to ``log_dir/trace.json`` for
    Perfetto or chrome://tracing. No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
