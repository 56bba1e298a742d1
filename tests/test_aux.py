"""Auxiliary subsystems: checkpoint/resume sweeps, profiling metrics
(SURVEY.md §5 build items)."""

import numpy as np

from triple_accel_jax import LEVENSHTEIN_COSTS, SearchType
from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
from triple_accel_jax.oracle import levenshtein_search_naive_with_opts
from triple_accel_jax.sweep import levenshtein_search_sweep
from triple_accel_jax.utils.checkpoint import SweepCheckpoint
from triple_accel_jax.utils.profiling import Throughput


def _workload(n=30000, m=12, k=2, seed=3):
    rng = np.random.default_rng(seed)
    needle = rng.integers(33, 127, m).astype(np.uint8)
    hay = rng.integers(33, 127, n).astype(np.uint8)
    for pos in rng.integers(0, n - m, 20):
        hay[pos : pos + m] = needle
    return needle, hay, k


def test_sweep_equals_monolithic():
    needle, hay, k = _workload()
    for st in (SearchType.All, SearchType.Best):
        ref = levenshtein_search_naive_with_opts(
            needle, hay, k, st, LEVENSHTEIN_COSTS, False
        )
        got = levenshtein_search_sweep(
            needle, hay, k, st, LEVENSHTEIN_COSTS, slab_chars=7000
        )
        assert got == ref, st


def test_sweep_mesh_equals_meshless():
    """levenshtein_search_sweep(mesh=): every slab runs sharded across
    the mesh; results must equal the meshless sweep and the oracle."""
    import jax

    from triple_accel_jax.parallel import make_mesh

    needle, hay, k = _workload()
    mesh = make_mesh(jax.devices()[:4])
    for st in (SearchType.All, SearchType.Best):
        ref = levenshtein_search_sweep(
            needle, hay, k, st, LEVENSHTEIN_COSTS, slab_chars=7000
        )
        got = levenshtein_search_sweep(
            needle, hay, k, st, LEVENSHTEIN_COSTS, slab_chars=7000,
            mesh=mesh,
        )
        assert got == ref, st


def test_sweep_resume(tmp_path):
    needle, hay, k = _workload()
    ck = str(tmp_path / "sweep.npz")

    # simulate a preemption: run only the first slab manually
    full = levenshtein_search_sweep(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS, slab_chars=7000
    )
    # seed a checkpoint as if the first two slabs completed, then resume
    partial = SweepCheckpoint.load_or_create(ck)
    first_two = [m for m in full if m.end <= 14000]
    partial.advance(14000, first_two)
    resumed = levenshtein_search_sweep(
        needle, hay, k, SearchType.All, LEVENSHTEIN_COSTS,
        slab_chars=7000, checkpoint_path=ck,
    )
    assert resumed == full
    import os

    assert not os.path.exists(ck)  # consumed on success


def test_checkpoint_roundtrip(tmp_path):
    from triple_accel_jax import Match

    p = str(tmp_path / "c.npz")
    c = SweepCheckpoint.load_or_create(p)
    c.advance(123, [Match(1, 5, 2)], curr_k=2)
    c2 = SweepCheckpoint.load_or_create(p)
    assert c2.offset == 123
    assert c2.matches == [Match(1, 5, 2)]
    assert c2.curr_k == 2


def test_throughput_report():
    t = Throughput()
    with t.measure(pairs=100, bytes_processed=1000):
        pass
    r = t.report()
    assert r["pairs_per_sec"] > 0 and r["bytes_per_sec"] > 0
    assert r["seconds"] == t.seconds


def test_compile_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set (and nothing else is set);
    otherwise the cache sits at the fixed path inside the checkout."""
    import os

    import jax

    from triple_accel_jax.utils import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert runtime.setup_compile_cache() == runtime.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == runtime.CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.CACHE_DIR == os.path.join(root, ".jax_cache")


def test_require_gpu_refuses_other_backends():
    """Measurement scripts stop on a backend that is not a GPU."""
    import pytest

    from triple_accel_jax.utils.runtime import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_sweep_best_curr_k_shrinks(tmp_path):
    # Best mode: the running minimum persists in the checkpoint and later
    # slabs search with the shrunken threshold — results identical to the
    # monolithic search.
    import numpy as np
    from triple_accel_jax import SearchType, levenshtein_search
    from triple_accel_jax.levenshtein import levenshtein_search_simd_with_opts
    from triple_accel_jax.types import LEVENSHTEIN_COSTS

    rng = np.random.default_rng(5)
    hay = rng.integers(65, 70, 4000).astype(np.uint8)
    needle = np.frombuffer(b"needle!x", np.uint8)
    hay[3500:3508] = needle  # exact hit late: curr_k must already be small
    hay[100:108] = needle
    hay[102] = 65  # one-off early hit
    ref = levenshtein_search_simd_with_opts(
        needle, hay, 4, SearchType.Best, LEVENSHTEIN_COSTS, False
    )
    ck = str(tmp_path / "s.npz")
    got = levenshtein_search_sweep(
        needle, hay, 4, SearchType.Best, slab_chars=512, checkpoint_path=ck
    )
    assert got == ref


def test_multihost_allgather_single_process():
    from triple_accel_jax.parallel.multihost import (
        allgather_matches,
        decode_matches,
        encode_matches,
    )
    from triple_accel_jax.types import Match

    ms = [Match(1, 5, 2), Match(7, 9, 0)]
    assert allgather_matches(ms) == ms
    assert allgather_matches([]) == []
    assert decode_matches(encode_matches(ms)) == ms


def test_dump_lowered(tmp_path):
    import numpy as np
    from triple_accel_jax.utils.inspect_ir import dump_lowered

    def f(x):
        return x * 2 + 1

    p = str(tmp_path / "f.stablehlo.txt")
    text = dump_lowered(f, np.ones(8, np.int32), path=p)
    assert "stablehlo" in text or "module" in text
    import os

    assert os.path.getsize(p) > 0
