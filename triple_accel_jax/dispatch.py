"""Trace-time dispatch: band sizing, cost-dtype bucketing, engine choice.

The reference picks an implementation at *runtime* from (CPU feature,
band size `unit_k`, threshold `max_k`) — levenshtein.rs:766-823, and its CI
forces each arm via cargo features.  Here the dispatcher picks a (engine,
cost dtype, padded-shape bucket) at *trace time* with the same numeric
rules, and environment flags replace the cargo feature matrix:

* ``TRIPLE_ACCEL_FORCE_PATH`` in {"oracle", "scan", "pallas"} forces an
  engine: the NumPy oracle, the `lax.scan` wavefronts, or the bit-parallel
  Pallas kernels (through Triton; GPU only — forcing them elsewhere
  raises).
* ``TRIPLE_ACCEL_DEBUG_DISPATCH=1`` logs every dispatch decision (the
  analog of the reference's `debug` feature println, levenshtein.rs:840-847).

`use_kernels()` is the one backend decision: the kernels run when JAX's
default backend is a GPU.  Tests run the kernel arms on the CPU through
`interpret_kernels()`, a test-only switch that makes the dispatcher call
the kernels with ``interpret=True``.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass

from .oracle.levenshtein import compute_max_k, compute_unit_k  # re-export
from .types import EditCosts

__all__ = [
    "compute_max_k",
    "compute_unit_k",
    "dispatch_unit_k",
    "select_cost_bucket",
    "forced_path",
    "use_kernels",
    "kernel_interpret",
    "interpret_kernels",
    "debug_dispatch",
    "round_up_pow2",
    "DispatchDecision",
    "last_dispatch",
    "dispatch_history",
]

# Reserve the dtype max as the overflow/infinity sentinel, exactly like the
# reference reserves u8::MAX etc. (levenshtein.rs:769: max_k <= u8::MAX - 1).
_COST_BUCKETS = (
    ("u8", (1 << 8) - 2),
    ("u16", (1 << 16) - 2),
    ("u32", (1 << 32) - 2),
)


def dispatch_unit_k(a_len: int, b_len: int, k: int, costs: EditCosts) -> int:
    """Band half-width as computed by the SIMD dispatcher.

    Unlike the scalar core's unit_k, the dispatcher additionally caps at
    max_len (reference levenshtein.rs:760-763).
    """
    max_k = compute_max_k(a_len, b_len, k, costs)
    return min(compute_unit_k(max_k, costs), max(a_len, b_len))


def select_cost_bucket(max_k: int) -> str:
    """Pick the narrowest cost dtype whose range (minus the INF sentinel)
    holds max_k — the trace-time analog of the 8/16/32-bit jewel ladder
    (reference levenshtein.rs:766-823)."""
    for name, cap in _COST_BUCKETS:
        if max_k <= cap:
            return name
    return "u32"


def forced_path() -> str | None:
    """Engine override from the environment: "oracle" | "scan" |
    "pallas"."""
    v = os.environ.get("TRIPLE_ACCEL_FORCE_PATH", "").strip().lower()
    return v if v in ("oracle", "scan", "pallas") else None


_INTERPRET_KERNELS = False


@contextmanager
def interpret_kernels(enabled: bool = True):
    """Test-only switch: while active, the dispatcher runs the kernel arms
    of its ladders on any backend, calling the kernels with
    ``interpret=True``."""
    global _INTERPRET_KERNELS
    prev = _INTERPRET_KERNELS
    _INTERPRET_KERNELS = enabled
    try:
        yield
    finally:
        _INTERPRET_KERNELS = prev


def kernel_interpret() -> bool:
    """The `interpret=` the dispatcher passes to the kernels: set only by
    `interpret_kernels()`, never derived from the platform."""
    return _INTERPRET_KERNELS


def use_kernels() -> bool:
    """Whether the bit-parallel recurrences (unit and rdamerau costs) run
    on the Pallas kernels: yes when JAX's default backend is a GPU or the
    test switch is on, no (the `lax.scan` wavefronts) otherwise or when
    the scan or the oracle is forced."""
    import jax

    fp = forced_path()
    if fp in ("scan", "oracle"):
        return False
    on_gpu = jax.default_backend() == "gpu"
    if fp == "pallas" and not (on_gpu or _INTERPRET_KERNELS):
        raise RuntimeError(
            "TRIPLE_ACCEL_FORCE_PATH=pallas needs a GPU backend (JAX's "
            f"default backend is {jax.default_backend()!r})"
        )
    return on_gpu or _INTERPRET_KERNELS


def _debug_enabled() -> bool:
    return os.environ.get("TRIPLE_ACCEL_DEBUG_DISPATCH", "") not in ("", "0")


def debug_dispatch(msg: str) -> None:
    """Dispatch-coverage logging (analog of the reference `debug` feature)."""
    if _debug_enabled():
        print(f"Debug: {msg}", file=sys.stderr)


def round_up_pow2(n: int, minimum: int = 8) -> int:
    """Round a length up to the next power of two to bound jit recompiles."""
    v = max(n, minimum)
    return 1 << (v - 1).bit_length()


@dataclass(frozen=True)
class DispatchDecision:
    """A record of one dispatch decision, for logging and tests."""

    path: str  # engine arm, e.g. "myers", "scan", "myers_search"
    cost_bucket: str  # "u8" | "u16" | "u32"
    unit_k: int
    max_k: int
    padded_m: int
    padded_n: int

    def log(self, routine: str) -> None:
        global _LAST_DISPATCH
        _LAST_DISPATCH = self
        _HISTORY.append((routine, self))
        if len(_HISTORY) > 64:
            del _HISTORY[:-64]
        debug_dispatch(
            f"{routine} path={self.path} cost={self.cost_bucket} "
            f"unit_k={self.unit_k} max_k={self.max_k} "
            f"padded=({self.padded_m},{self.padded_n})"
        )


_LAST_DISPATCH: DispatchDecision | None = None
_HISTORY: list = []


def last_dispatch() -> DispatchDecision | None:
    """The most recent dispatch decision — the testable face of the debug
    log (tests assert which kernel path a call actually took)."""
    return _LAST_DISPATCH


def dispatch_history(clear: bool = False) -> list:
    """Recent (routine, DispatchDecision) records, most recent last (ring
    of 64).  With clear=True, empties the ring after returning it — used
    by tests that assert how many device passes a call issued."""
    global _HISTORY
    out = list(_HISTORY)
    if clear:
        _HISTORY = []
    return out
