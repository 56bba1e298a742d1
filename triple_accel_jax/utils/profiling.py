"""Tracing, profiling and throughput metrics.

The reference's only profiling story is criterion benchmarks plus a script
to dump LLVM IR (SURVEY.md §5).  This package's equivalents:

* `trace(...)` — context manager around `jax.profiler` so any region can be
  captured for xprof/tensorboard (`TRIPLE_ACCEL_TRACE_DIR` or arg);
* `Throughput` — the pairs/s & bytes/s reporter used by bench.py-style
  harnesses (BASELINE.md headline metrics).

Roofline arithmetic for the H100 (a peak table keyed by device kind) is
left to the benchmark that measures against it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

__all__ = [
    "trace",
    "Throughput",
]


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a jax.profiler trace of the wrapped region when a trace dir
    is configured (arg or TRIPLE_ACCEL_TRACE_DIR); no-op otherwise."""
    trace_dir = trace_dir or os.environ.get("TRIPLE_ACCEL_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(name):
            yield


@dataclass
class Throughput:
    """Accumulates work items and wall time; reports rates.

    >>> t = Throughput()
    >>> with t.measure(pairs=10, bytes_processed=1000):
    ...     pass
    >>> t.pairs >= 10
    True
    """

    pairs: int = 0
    bytes_processed: int = 0
    seconds: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, pairs: int = 0, bytes_processed: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.pairs += pairs
            self.bytes_processed += bytes_processed

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_processed / self.seconds if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        out = {
            "pairs_per_sec": self.pairs_per_sec,
            "bytes_per_sec": self.bytes_per_sec,
            "seconds": self.seconds,
        }
        out.update(self.extra)
        return out
