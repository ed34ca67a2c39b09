"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharded
paths are exercised without an accelerator (SURVEY.md section 4.3).
Tests that need a GPU take the `gpu` fixture, which skips them here."""

import os

# force CPU before JAX initialises its backend (the config update below
# covers a process that imported jax before this file)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from minimap2_rs_tpu.utils import compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
compile_cache.configure()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.
    Decided when the test runs, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run: python -m pytest tests -m gpu on the card)")
    return dev
