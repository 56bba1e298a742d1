"""Device compute cores: `lax.scan` wavefronts and Pallas fast paths.

This layer is the device equivalent of the reference's L2 algorithm
cores + L1 Jewel SIMD vocabulary (SURVEY.md §1): banded wavefront DP for
every cost model and bit-parallel Myers kernels (ops/pallas/) for unit and
rdamerau costs, dispatched at trace time.
"""

from . import band_scan
from . import hamming_ops
from . import search_scan

__all__ = ["band_scan", "hamming_ops", "search_scan"]
