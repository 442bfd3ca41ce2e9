"""Mode-width relations: width as a parametric function of frequency.

The reference's `AppWidth` model families replace the per-mode free widths
with the Appourchaux et al. (2016, A&A 595, C2 corrigendum) relation fitted
over the whole p-mode ridge (`models.cpp — model_MS_Global_*_AppWidth_*` [U];
SURVEY.md section 2 "Model dictionary").  This cuts the free-parameter count
from N0 widths to 5 relation parameters + numax, and regularises the fit for
low-SNR stars.

The relation (all frequencies in the same unit, uHz here):

    ln Gamma(nu) = alpha * ln(nu/numax) + ln(Gamma_alpha)
                   - ln(dGamma_dip) / (1 + ((2 ln(nu/nu_dip))
                                            / ln(W_dip/numax))**2)

i.e. a power law in nu with a Lorentzian-in-log-frequency "dip" of depth
dGamma_dip (>1 suppresses width near nu_dip ~ numax) and log-width set by
W_dip.

XLA notes: pure closed-form jnp, differentiable in every parameter; the
relation is evaluated on the (static-shape) l=0 mode-frequency vector, so it
adds O(N0) flops — negligible next to the Lorentzian contraction.
"""

from __future__ import annotations

import jax.numpy as jnp


def appourchaux2016_width(nu, numax, alpha, gamma_alpha, dgamma_dip,
                          nu_dip, w_dip):
    """Gamma(nu) [uHz] from the Appourchaux+2016 relation.

    nu may be any shape; parameters are scalars (broadcastable).  Parameters
    are clipped away from the singular points (numax, nu_dip, w_dip,
    gamma_alpha, dgamma_dip > 0; W_dip != numax) so the sampler can roam.
    """
    numax = jnp.maximum(numax, 1e-3)
    nu_dip = jnp.maximum(nu_dip, 1e-3)
    gamma_alpha = jnp.maximum(gamma_alpha, 1e-6)
    dgamma_dip = jnp.maximum(dgamma_dip, 1.0 + 1e-6)
    w_dip = jnp.maximum(w_dip, 1e-3)
    nu = jnp.maximum(jnp.asarray(nu), 1e-3)

    log_ratio = jnp.log(nu / numax)
    denom_log = jnp.log(w_dip / numax)
    # keep |ln(W_dip/numax)| away from 0 (dip width degenerate with numax)
    denom_log = jnp.where(jnp.abs(denom_log) < 1e-3,
                          jnp.where(denom_log < 0, -1e-3, 1e-3), denom_log)
    dip = jnp.log(dgamma_dip) / (1.0 + (2.0 * jnp.log(nu / nu_dip)
                                        / denom_log) ** 2)
    return jnp.exp(alpha * log_ratio + jnp.log(gamma_alpha) - dip)
