"""L1 spectrum-model kernels (pure jnp, differentiable, jit/vmap-safe).

Design notes for XLA (vs the C++ reference, SURVEY.md section 2):
  * the reference evaluates each Lorentzian only inside a truncation window
    c*Gamma around the mode (data-dependent control flow).  Here every mode is
    evaluated densely on the full frequency grid and accumulated with one
    vectorized contraction — static shapes, XLA-fusable, VPU-friendly.
  * all builders are differentiable so the MALA drift can come from jax.grad.
"""

from tamcmc_tpu.ops.visibilities import mode_visibility  # noqa: F401
from tamcmc_tpu.ops.rotation import (  # noqa: F401
    rl_polynomials, qlm, split_frequencies_a1etaa3, split_frequencies_aj,
)
from tamcmc_tpu.ops.noise import harvey_like, harvey_1985, noise_background  # noqa: F401
from tamcmc_tpu.ops.lorentzian import lorentzian_profile, sum_lorentzians  # noqa: F401
