"""Tracing / metrics: per-stage wall timers + optional JAX profiler traces.

The reference's only observability is verbose stderr timestamps
(/root/reference/src/krisp/krisp_fasta/krisp_fasta.py:47-63) and the
krisp_vcf status line.  Here metrics are a first-class module: every engine
stage records wall time and item counts into a process-global registry; a
JAX profiler trace can be captured around any region for xprof analysis.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field


@dataclass
class StageStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0

    def rate(self):
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class Metrics:
    stages: "OrderedDict[str, StageStat]" = field(default_factory=OrderedDict)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        stat = self.stages.setdefault(name, StageStat())
        t0 = time.perf_counter()
        try:
            yield stat
        finally:
            stat.seconds += time.perf_counter() - t0
            stat.calls += 1
            stat.items += items

    def count(self, name: str, items: int = 1):
        """Count an event that takes no time of its own (e.g. a retry)."""
        stat = self.stages.setdefault(name, StageStat())
        stat.calls += 1
        stat.items += items

    def report(self, stream=None):
        stream = stream or sys.stderr
        width = max([len(n) for n in self.stages] + [5])
        for name, s in self.stages.items():
            rate = f"  {s.rate():,.0f} items/s" if s.items else ""
            print(f"  {name.ljust(width)} {s.seconds:8.3f}s"
                  f"  x{s.calls}{rate}", file=stream)

    def reset(self):
        self.stages.clear()


#: process-global registry used by the engine; CLIs report it under
#: --verbose.
GLOBAL = Metrics()


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a JAX profiler trace (xprof/tensorboard format) around a
    region when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
