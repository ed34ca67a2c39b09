"""Where JAX keeps its persistent compilation cache.

The CLI, bench.py, chip_smoke.py and the tests call configure() before
their first compile. A cache hits only when its directory stays put, so
the path is fixed: JAX_COMPILATION_CACHE_DIR when the environment sets it
(JAX reads the variable itself, and nothing else is set here), otherwise
`.jax_cache/` at the root of the checkout (listed in .gitignore)."""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    return CHECKOUT_DIR
