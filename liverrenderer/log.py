"""Logging, progress and profiling utilities.

Analog of the reference observability stack (src/core/logger.cpp appenders/
formatters, progress.cpp ProgressReporter bars, profiler.h ScopedPhase
markers): log levels with a global threshold, elapsed-time-stamped lines,
a throttled progress bar, and scoped wall-clock phase timers whose summary
mirrors the realtime viewer's per-stage report (realtime.hpp:563-588).
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager

TRACE, DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3, 4
_NAMES = {TRACE: "TRACE", DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN",
          ERROR: "ERROR"}

_level = INFO
_t0 = time.time()


def set_log_level(level: int) -> None:
    global _level
    _level = level


def log(msg: str, level: int = INFO) -> None:
    if level < _level:
        return
    elapsed = time.time() - _t0
    print(f"[{elapsed:8.3f}s] {_NAMES[level]:5s} {msg}",
          file=sys.stderr if level >= WARN else sys.stdout, flush=True)


class ProgressReporter:
    """Throttled progress bar (reference src/core/progress.cpp)."""

    def __init__(self, label: str, total: int, min_interval: float = 0.5):
        self.label = label
        self.total = max(total, 1)
        self.min_interval = min_interval
        self._last = 0.0
        self._start = time.time()

    def update(self, done: int) -> None:
        now = time.time()
        if now - self._last < self.min_interval and done < self.total:
            return
        self._last = now
        frac = min(done / self.total, 1.0)
        bar = "#" * int(30 * frac) + "-" * (30 - int(30 * frac))
        eta = (now - self._start) / max(frac, 1e-9) * (1 - frac)
        end = "\n" if done >= self.total else "\r"
        print(f"{self.label} [{bar}] {100 * frac:5.1f}% eta {eta:6.1f}s",
              end=end, file=sys.stderr, flush=True)


_phase_totals: dict = defaultdict(float)
_phase_counts: dict = defaultdict(int)
_xprof = False


@contextmanager
def scoped_phase(name: str):
    """RAII phase marker (profiler.h ScopedPhase): accumulates wall time
    per phase; `phase_report()` prints the per-stage summary.  While a
    device trace is active (`device_trace`), each phase also emits a
    jax.profiler TraceAnnotation so the spans line up with the XLA
    device timeline in the captured profile."""
    t0 = time.time()
    ctx = None
    if _xprof:
        import jax
        ctx = jax.profiler.TraceAnnotation(name)
        ctx.__enter__()
    try:
        yield
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
        dt = time.time() - t0
        _phase_totals[name] += dt
        _phase_counts[name] += 1


@contextmanager
def device_trace(log_dir: str):
    """Capture a device-level profile (XLA ops and kernels on the device)
    into ``log_dir`` for TensorBoard/xprof — the hardware-level
    half of the reference's profiler.h sample-based profiler, which only
    saw CPU stacks.  Phase markers taken inside the block become
    TraceAnnotations on the same timeline.  CLI: `--trace DIR`."""
    global _xprof
    import jax
    jax.profiler.start_trace(log_dir)
    _xprof = True
    try:
        yield
    finally:
        _xprof = False
        jax.profiler.stop_trace()
        log(f"device trace written to {log_dir}")


def phase_report() -> str:
    lines = ["phase timings:"]
    for name, total in sorted(_phase_totals.items(), key=lambda kv: -kv[1]):
        n = _phase_counts[name]
        lines.append(f"  {name:28s} {total:9.3f}s total"
                     f"  {total / n * 1000:9.2f} ms/call  x{n}")
    return "\n".join(lines)


def reset_phases() -> None:
    _phase_totals.clear()
    _phase_counts.clear()
