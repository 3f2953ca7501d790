"""Tracing and profiling hooks.

The reference's timing is metric-grade only (cumulative PGO/sparsification
wall-clock, SURVEY.md §5 "no structured tracer"). Here:

- ``span(name)`` — host-side span timing with an accumulating registry
  (count / total / max per span), cheap enough to leave on in production;
- ``device_trace(logdir)`` — wraps ``torch.profiler.profile`` so any region
  can be captured as a Chrome trace with per-kernel device timelines;
- ``annotate(name)`` — ``torch.profiler.record_function`` passthrough to
  label host regions inside a device trace.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

_lock = threading.Lock()
_registry: Dict[str, Dict[str, float]] = {}


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Accumulate wall-clock for a named region into the span registry.

    Spans entered from non-main threads (e.g. the background tier
    prefetcher, which drives the SAME dispatch chokepoints as production)
    are recorded under ``name (bg)``: their time is concurrent with the
    main loop, and folding it in silently inflated the round-4 e2e span
    table (mac.fw_dispatch "131 s" included 60+ s of background prefetch
    compiles that never blocked the pipeline)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if threading.current_thread() is not threading.main_thread():
            name = name + " (bg)"
        with _lock:
            rec = _registry.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += dt
            rec["max_s"] = max(rec["max_s"], dt)


def spans() -> Dict[str, Dict[str, float]]:
    """Snapshot of the span registry."""
    with _lock:
        return {k: dict(v) for k, v in _registry.items()}


_counters: Dict[str, float] = {}


def counter(name: str, n: float = 1.0) -> None:
    """Accumulate a named event count (rates, hit/miss tallies). Reported
    alongside the span table; reset with :func:`reset_spans`."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + n


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def reset_spans() -> None:
    with _lock:
        _registry.clear()
        _counters.clear()


def report(reset: bool = False) -> str:
    """Human-readable span table."""
    rows = sorted(spans().items(), key=lambda kv: -kv[1]["total_s"])
    lines = [f"{'span':<42} {'count':>7} {'total_s':>10} {'mean_ms':>9} "
             f"{'max_ms':>9}"]
    for name, rec in rows:
        mean_ms = rec["total_s"] / max(rec["count"], 1) * 1e3
        lines.append(f"{name:<42} {rec['count']:>7} {rec['total_s']:>10.3f} "
                     f"{mean_ms:>9.2f} {rec['max_s'] * 1e3:>9.2f}")
    cnts = counters()
    if cnts:
        lines.append(f"{'counter':<42} {'value':>7}")
        for name in sorted(cnts):
            lines.append(f"{name:<42} {cnts[name]:>7.0f}")
    if reset:
        reset_spans()
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a torch profiler trace of the host and the CUDA device
    (Chrome trace format, written under ``logdir``)."""
    import os

    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Label a host region inside a device trace."""
    import torch
    return torch.profiler.record_function(name)


class CompileWatch:
    """Same API as the JAX package's compile counter, as a no-op.

    Eager PyTorch compiles no programs per shape, so a steady region has
    nothing to count: ``count`` and ``background_count`` stay 0 and the
    name lists stay empty. (The bank-scan kernel is built once per process
    at first use, outside any steady region.)
    """

    def __init__(self):
        self.count = 0
        self.names: list = []
        self.background_count = 0
        self.background_names: list = []
        self.miss_explanations: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
