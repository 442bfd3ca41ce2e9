"""Sampler state pytree and hyperparameters.

Reference equivalent: the mutable per-chain members of `MALA`/`Model_def`
(`MALA.h`, `model_def.h` [U]; SURVEY.md section 2 "Adaptive MALA sampler").
Redesign for XLA: ALL tempered chains and walkers live as leading array
axes (T = temperatures, C = walkers per temperature, Df = free dims) of one
immutable pytree carried through `lax.scan`.

Adaptation statistics (mu, cov, sigma) default to the walker-ensemble
estimator when C is large enough (cross-walker pooled moments per
temperature — a psum over the chain mesh axis when walkers are sharded) and
fall back to per-walker expanding-window moments at small C (the reference's
per-chain Atchade scheme, batched); see MALAHyper.cov_estimator.
On tempering swaps the stats stay with the (rung, walker slot), not the
wandering parameter vector — standard adaptive-parallel-tempering practice
(SURVEY.md section 3.5 flags this as the parity-sensitive choice).

STANDARDIZED SAMPLING SPACE: `theta` (and mu/cov/chol/grad*) live in a
per-problem affine "u-space", x = u_center + u_scale * u, where u_scale is
the prior-derived per-parameter scale and u_center the start vector.  The
physical parameter space mixes O(1e3) frequencies with O(1e-3) noise
amplitudes: in float32 the proposal increment sigma*chol*xi underflows
against theta once sigma*scale approaches ulp(theta) (~2.6e-4 at 2200 uHz),
and the reverse-drift residual |theta - mean_rev|^2/sigma^2 then divides
quantization noise by sigma^2 — the MH correction turns into a huge negative
random term, everything rejects, and the Robbins-Monro scale death-spirals
to log_sigma_min (diagnosed on BASELINE config 4: acceptance FELL from 0.59
to 0.05 as sigma fell 4 decades).  In u-space every coordinate is O(1), so
the ulp wall sits ~6 decades below any useful sigma.  Analytic targets get
the identity map (center 0, scale 1).  Records and checkpoints written by
the drivers are unmapped back to physical space at emit time."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tamcmc_tpu.utils.constants import TARGET_ACCEPTANCE


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SamplerState:
    theta: jnp.ndarray       # (T, C, Df) positions in STANDARDIZED u-space
    logL: jnp.ndarray        # (T, C) untempered log-likelihood
    logP: jnp.ndarray        # (T, C) log-prior
    gradL: jnp.ndarray       # (T, C, Df) d logL / d theta
    gradP: jnp.ndarray       # (T, C, Df) d logP / d theta
    mu: jnp.ndarray          # (T, C, Df) per-walker adaptive proposal mean
    cov: jnp.ndarray         # (T, C, Df, Df) per-walker proposal covariance
    chol: jnp.ndarray        # (T, C, Df, Df) cholesky(cov + eps I)
    ichol: jnp.ndarray       # (T, C, Df, Df) inv(chol), refreshed with it:
                             # turns the per-step reverse-kernel triangular
                             # solve (Df sequential substitution steps, a
                             # latency-bound chain) into one batched
                             # matvec; zeros in RW mode (never read)
    log_sigma: jnp.ndarray   # (T, C) per-walker adaptive scale (log)
    step: jnp.ndarray        # () global iteration counter (adaptation clock)
    naccept: jnp.ndarray     # (T,) accepted proposals (summed over walkers /C)
    nprop: jnp.ndarray       # () proposals per (t, c) slot
    acc_rate: jnp.ndarray    # (T, C) smoothed instantaneous acceptance rate
    nswap_att: jnp.ndarray   # (T,) swap attempts of pair (t, t+1); last row 0
    nswap_acc: jnp.ndarray   # (T,) accepted swaps of pair (t, t+1)
    scales0: jnp.ndarray     # (Df,) initial per-param U-SPACE scales
                             # (cov floor; ones for standardized problems)
    u_center: jnp.ndarray    # (Df,) physical = u_center + u_scale * theta
    u_scale: jnp.ndarray     # (Df,) prior-derived standardization scales

    def replace(self, **fields) -> "SamplerState":
        return dataclasses.replace(self, **fields)


@dataclasses.dataclass(frozen=True)
class MALAHyper:
    """Static hyperparameters of the Atchade (2006) adaptive scheme.

    Reference equivalents are the MALA section of `config_default.cfg`
    (epsilon1/epsilon2/A1/delta/delta_x ... [U]); names here are descriptive.
    """
    target_acceptance: float = None  # None -> optimal-scaling default by
                                    # proposal type: 0.574 with the MALA
                                    # drift, 0.234 for random walk (Roberts &
                                    # Rosenthal; the reference always targets
                                    # 0.234 because its drift is off [U])
    use_drift: bool = True          # False -> adaptive RW-Metropolis (the
                                    # reference's default operating mode [U])
    cov_estimator: str = "auto"     # "ensemble": pooled cross-walker
                                    #   covariance per temperature
                                    #   (statistically free with a real
                                    #   walker ensemble and immune to the
                                    #   single-trajectory shrinkage spiral)
                                    # "walker": each walker's own expanding-
                                    #   window moments (the reference's
                                    #   per-chain scheme)
                                    # "auto": ensemble iff C is large enough
                                    #   to estimate a Df-dim covariance
                                    #   (2*C >= Df).  A C-walker ensemble
                                    #   covariance has rank C-1: with C <<
                                    #   Df proposals collapse into the
                                    #   walker-spread subspace, whose scale
                                    #   tracks the (growing) burn-in
                                    #   dispersion — acceptance falls at ANY
                                    #   sigma and the Robbins-Monro scale
                                    #   pins at log_sigma_min (diagnosed on
                                    #   BASELINE config 4 with C=4, Df=41)
    cov_floor: float = 1e-4         # proposal cov += floor*diag(scales0^2):
                                    # keeps a minimum exploration scale so a
                                    # collapsed/deficient estimate can never
                                    # freeze a walker permanently
    drift_delta: float = 1000.0     # Atchade truncation bound on |grad|
    gain_c0: float = 1.0            # gamma_k = c0 / (k0 + k)^alpha
    gain_k0: float = 10.0
    gain_alpha: float = 0.6
    eps_cov: float = 1e-8           # ridge added before cholesky
    dN_chol: int = 10               # refresh chol(Sigma) every K adapt steps:
                                    # small-matrix Cholesky is latency-bound;
                                    # mu/Sigma still update every step
    log_sigma_min: float = -15.0    # Atchade projection bounds on the scale
    log_sigma_max: float = 4.0
    sigma0_scale: float = 1.0       # initial sigma = 2.38/sqrt(Df) * this
    dN_mixing: int = 10             # tempering swap cadence (reference name)
    lambda_temp: float = 1.4        # geometric ladder T_k = lambda^k
    acc_smooth: float = 0.02        # EMA factor for reported acceptance
    adapt_ladder: bool = False      # Vousden et al. (2016) dynamic
                                    # temperature selection: per-rung betas
                                    # tuned toward uniform pair swap
                                    # acceptance during Learning, frozen in
                                    # Acquire (sampler/ladder.py; host-side
                                    # between-chunk updates).  BEYOND
                                    # REFERENCE (fixed geometric ladder
                                    # there) — off by default; local runner
                                    # only
    sigma_acc_estimator: str = "expected"
                                    # which acceptance estimate drives the
                                    # Robbins-Monro log-sigma update:
                                    #  "expected" — E[accept] = min(1,exp(dlog))
                                    #    (Rao-Blackwellised, lower-variance;
                                    #    this repo's round-1 behaviour)
                                    #  "realized" — the 0/1 accept indicator
                                    #    (Atchade 2006 as written; presumed
                                    #    reference scheme [U] — see
                                    #    docs/PARITY.md "sigma adaptation")

    def resolved_target(self) -> float:
        if self.target_acceptance is not None:
            return self.target_acceptance
        return 0.574 if self.use_drift else TARGET_ACCEPTANCE

    def resolved_cov_estimator(self, n_chains: int, ndim_free: int) -> str:
        """Static resolution of the 'auto' covariance estimator (see the
        cov_estimator field docs for the failure mode this prevents)."""
        if self.cov_estimator != "auto":
            return self.cov_estimator
        return "ensemble" if 2 * n_chains >= ndim_free else "walker"
