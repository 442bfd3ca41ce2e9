"""Test fixture: CPU backend with 8 fake devices, so the full multi-device
sharding path (shard_map over a (temp, chain) mesh, ppermute swaps, psum
adaptation reductions) is exercised without accelerators.

JAX_PLATFORMS defaults to cpu here.  Tests marked `gpu` need the card: run
them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` (or
`python chip_smoke.py`, which does); elsewhere the `gpu` fixture skips them.

This mirrors the reference's "validation ladder" gap: OthmanB/TAMCMC-C- has
no automated tests (SURVEY.md section 4); we build the pyramid it lacks.
MUST run before any `import jax` anywhere in the test process.
"""
import os
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Keep compile time sane in tests.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pytest  # noqa: E402

from tamcmc_tpu.utils.cache import enable_compile_cache  # noqa: E402

# XLA:CPU compiles dominate the suite; the persistent cache makes reruns fast
enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX runs on no GPU.
    Decided here, at test time, never at import (xdist workers must all
    collect the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python chip_smoke.py)")
    return jax.devices()[0]
