"""Pallas kernels for the GPU (through Triton) and their plain-XLA twins:
the bit-parallel Myers engines for unit and rdamerau costs.

`words.py` holds the multi-word uint32 bit-vector arithmetic both engines
share; `myers_distance.py` the banded pair distance; `myers_search.py` the
approximate search, its device-side haystack windowing and the two-phase
hit fetch."""

from . import myers_distance, myers_search, words

__all__ = ["myers_distance", "myers_search", "words"]
