"""Process set-up shared by chip_smoke.py, the benches and the tests: the
persistent compile cache, the GPU requirement of measurement scripts, and
the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess

__all__ = ["CACHE_DIR", "setup_compile_cache", "require_gpu", "gpu_info"]

# fixed path inside the checkout (listed in .gitignore): the cache key
# includes the path, so a directory that moves never hits
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when it is set (and set nothing else), otherwise at CACHE_DIR.
    Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return CACHE_DIR


def require_gpu():
    """Fail unless JAX's default backend is a GPU; returns
    (platform, device_kind, device_count).  Measurement scripts never
    carry on on another backend."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {backend!r}")
    dev = jax.devices()[0]
    return dev.platform, dev.device_kind, len(jax.devices())


def gpu_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the cards, read by a
    child process that does not import JAX ("not measured" without the
    tool)."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip() if res.returncode == 0 else "not measured"
