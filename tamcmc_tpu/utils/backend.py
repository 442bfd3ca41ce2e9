"""Which device the program runs on, and saying so.

The sampler is meant for an NVIDIA GPU.  Left to itself, JAX falls back to
the CPU with a warning when CUDA does not come up, and a fit then runs for
hours on the wrong device.  So a GPU run names its platforms explicitly:
`cuda` for the sampler, and the host `cpu` beside it for one-shot set-up work
(demo data generation, window assembly).  JAX then fails at start-up when
the CUDA plugin is installed but no card comes up; where the plugin is
missing altogether it quietly keeps only the CPU, so `ensure_gpu` checks the
backend it got.  `JAX_PLATFORMS=cpu` is the one way to ask for a CPU run
(tests, f64 validation).
"""

import os
import subprocess

GPU_PLATFORMS = "cuda,cpu"
# XLA's autotuner compiles and times candidate kernels for every fusion at
# the real shapes.  On the full-width models (120,000 bins x 640 walkers)
# that held one forward+backward compile past 165 s on an H100; without it
# the same compile took 30 s.  Read by XLA when the backend starts.
GPU_XLA_FLAGS = ("--xla_gpu_autotune_level=0",)


def add_gpu_xla_flags() -> None:
    """Append GPU_XLA_FLAGS to XLA_FLAGS (a flag the user already set
    wins).  Must run before the backend starts."""
    flags = os.environ.get("XLA_FLAGS", "")
    for flag in GPU_XLA_FLAGS:
        if flag.split("=")[0] not in flags:
            flags = f"{flags} {flag}".strip()
    os.environ["XLA_FLAGS"] = flags


def request_gpu_unless_told() -> None:
    """Ask for CUDA (plus the host CPU) unless JAX_PLATFORMS names the
    platforms, with the GPU compile flags wherever CUDA is asked for.
    Must run before the first backend call."""
    platforms = os.environ.get("JAX_PLATFORMS", "").strip()
    if not platforms:
        import jax
        jax.config.update("jax_platforms", GPU_PLATFORMS)
        platforms = GPU_PLATFORMS
    if "cuda" in platforms:
        add_gpu_xla_flags()


def ensure_gpu() -> None:
    """Where the GPU platforms were asked for, exit non-zero unless the
    backend JAX started is a GPU.  Initialises the backend: call it where
    the command first needs a device (after any jax.distributed set-up)."""
    import jax
    if jax.config.jax_platforms != GPU_PLATFORMS:
        return
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU found (JAX's backend is {backend!r}); "
                         "set JAX_PLATFORMS=cpu to run on the CPU")


def require_gpu() -> None:
    """Insist on a GPU, whatever JAX_PLATFORMS says: for commands whose only
    purpose is to run or measure on the card (bench, chip smoke)."""
    import jax
    add_gpu_xla_flags()
    jax.config.update("jax_platforms", GPU_PLATFORMS)
    ensure_gpu()


def device_info() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the first card, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'.  Raises when nvidia-smi is missing
    or fails: a number measured on a card is reported with both."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
