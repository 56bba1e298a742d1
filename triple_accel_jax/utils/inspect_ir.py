"""Dump lowered IR for kernel inspection (build_ir_asm.sh analog).

The reference ships `build_ir_asm.sh` (reference repo root, line 1) to
emit LLVM-IR/asm of its SIMD cores for eyeballing codegen.  The JAX
equivalents are StableHLO (what JAX traces to; a Pallas kernel appears as
a Triton custom call carrying its TTIR) and the compiled HLO (after XLA's
fusion/layout passes, for the backend that compiles it).

Usage (library):

    from triple_accel_jax.utils.inspect_ir import dump_lowered
    text = dump_lowered(fn, *example_args, compiled=True)

Usage (CLI — dumps the flagship kernels to ./ir_dump/; StableHLO is
lowered for CUDA and works on any host, --compiled needs a GPU):

    python -m triple_accel_jax.utils.inspect_ir [outdir] [--compiled]
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Optional, Sequence

__all__ = ["dump_lowered", "dump_flagship_kernels"]


def dump_lowered(
    fn: Callable[..., Any],
    *args: Any,
    compiled: bool = False,
    path: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
    **kwargs: Any,
) -> str:
    """Return (and optionally write) the lowered IR of `fn(*args)`.

    `compiled=False` gives the StableHLO module as traced, lowered for
    `platforms` (e.g. ("cuda",)) when given; `compiled=True` gives XLA's
    post-optimization HLO for the default backend.  `fn` may already be
    jitted.
    """
    import jax

    jfn = fn if hasattr(fn, "trace") else jax.jit(fn)
    if compiled:
        text = jfn.lower(*args, **kwargs).compile().as_text()
    else:
        traced = jfn.trace(*args, **kwargs)
        lowered = (traced.lower(lowering_platforms=tuple(platforms))
                   if platforms else traced.lower())
        text = lowered.as_text()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def dump_flagship_kernels(outdir: str = "ir_dump",
                          compiled: bool = False) -> None:
    """Dump StableHLO (lowered for CUDA) and, with `compiled`, the
    compiled HLO of the main device paths: the bit-parallel distance
    kernel and the banded scan wavefront."""
    from functools import partial

    import numpy as np

    from ..ops.band_scan import band_scan_distance, prepare_band_inputs
    from ..ops.pallas.myers_distance import (
        myers_distance_triton,
        prepare_myers_inputs,
    )

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    a = [rng.integers(33, 127, 256).astype(np.uint8) for _ in range(256)]
    b = [rng.integers(33, 127, 256).astype(np.uint8) for _ in range(256)]
    K, MAX_M = 32, 256
    tags = [(False, "stablehlo")] + ([(True, "hlo_opt")] if compiled else [])

    margs = prepare_myers_inputs(a, b, K, MAX_M)
    jfn = partial(myers_distance_triton, k=K, max_m=MAX_M)
    for comp, tag in tags:
        p = os.path.join(outdir, f"myers_distance.{tag}.txt")
        dump_lowered(jfn, *margs, compiled=comp, path=p, platforms=("cuda",))
        print(f"wrote {p}")

    a_pad, b_pad, m_arr, n_arr = prepare_band_inputs(a, b, 32, MAX_M)
    jfn2 = partial(
        band_scan_distance,
        unit_k=32, max_m=MAX_M, costs_t=(1, 1, 0, 0, False), trace_on=False,
    )
    for comp, tag in tags:
        p = os.path.join(outdir, f"band_scan.{tag}.txt")
        dump_lowered(jfn2, a_pad, b_pad, m_arr, n_arr, compiled=comp,
                     path=p, platforms=("cuda",))
        print(f"wrote {p}")


if __name__ == "__main__":
    args = [x for x in sys.argv[1:] if x != "--compiled"]
    dump_flagship_kernels(args[0] if args else "ir_dump",
                          compiled="--compiled" in sys.argv[1:])
