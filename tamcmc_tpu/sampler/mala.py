"""Adaptive truncated-drift MALA step (Atchade 2006).

Reference equivalent: `MALA::D_MALA` + the Robbins-Monro updates in
`MALA.cpp` [U] (SURVEY.md sections 2, 3.1).  Differences by design:

  * the drift uses REAL autodiff gradients (jax.vjp through the fused
    model+likelihood+prior), where the reference's default mode disables the
    drift and falls back to adaptive random-walk Metropolis.  `use_drift=False`
    reproduces the reference's RW behaviour exactly (the q-ratio terms cancel).
  * one step advances ALL (T temperatures x C walkers) simultaneously —
    the reference's serial per-chain loop becomes batched linear algebra.
  * adaptation statistics (mu, Sigma, sigma): two estimators, resolved
    statically by MALAHyper.cov_estimator.  "ensemble" pools cross-walker
    moments per temperature (a mean over the C axis — a psum over the chain
    mesh axis when walkers are sharded); "walker" keeps each walker's own
    expanding-window trajectory moments (the reference's per-chain scheme,
    batched, no cross-walker reduction).  "auto" picks ensemble iff
    2*C >= Df (see state.py for the rank-deficiency rationale).
  * the sampler works in the problem's STANDARDIZED u-space (see state.py
    "STANDARDIZED SAMPLING SPACE"): proposals, adaptation and the scan carry
    are all O(1) per coordinate; physical parameters are reconstructed as
    x = u_center + u_scale * u only to evaluate the model.

Proposal:    x' = x + (sigma^2/2) Sigma D(x) + sigma chol(Sigma) xi
Truncation:  D(x) = g * min(1, delta/|g|),  g = beta gradL + gradP
Acceptance:  log a = beta dlogL + dlogP + log q(x|x') - log q(x'|x)
Adaptation:  mu    += gamma_k (mean_C x - mu)
             Sigma += gamma_k (E_C[(x-mu)(x-mu)^T] - Sigma)   (+ eps I ridge)
             log sigma += gamma_k (acc - 0.234), clipped to projection bounds
             gamma_k = c0/(k0 + k)^alpha  (Robbins-Monro, truncated drift)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tamcmc_tpu.sampler.state import SamplerState, MALAHyper
from tamcmc_tpu.sampler.problem import Problem


def _matvec(a, v):
    """Per-walker (T, C, Df, Df) @ (T, C, Df) at full f32 precision.

    Pinned at every call site: on a GPU an unpinned f32 product may run in
    TF32 (~3 decimal digits), and a proposal built in TF32 while logq_fwd is
    taken from the exact xi no longer matches the MH ratio — a silent
    posterior bias.  The products are Df x Df per walker, negligible next
    to the Lorentzian stream."""
    return jnp.einsum("tcij,tcj->tci", a, v,
                      precision=jax.lax.Precision.HIGHEST)


def _truncate_drift(g, delta):
    """Atchade's truncation: scale gradient to norm <= delta (per walker)."""
    norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g * jnp.minimum(1.0, delta / jnp.maximum(norm, 1e-30))


def _batched_tri_inverse(chol):
    """inv(L) per walker via one batched triangular solve against I.

    Runs only at the amortised dN_chol refresh: the per-STEP reverse-kernel
    computation then needs just `einsum(ichol, r)` instead of a triangular
    solve — Df sequential substitution steps off the hot path
    (triangular solves are latency-bound chains of tiny dependent ops)."""
    eye = jnp.broadcast_to(jnp.eye(chol.shape[-1], dtype=chol.dtype),
                           chol.shape)
    return jax.scipy.linalg.solve_triangular(chol, eye, lower=True)


def init_state(problem: Problem, hp: MALAHyper, n_temps: int, n_chains: int,
               key, init_scales=None, jitter: float = 1e-4) -> SamplerState:
    """Initial state: all walkers at params0(+jitter); Sigma = diag(scales^2).

    init_scales: (Df,) per-parameter PHYSICAL proposal scales.  Default:
    derived from the prior table (Gaussian sigma; uniform range/100;
    fallback |p0|/100), mirroring the role of the reference's per-parameter
    initial step sizes from the .model file's prior hyperparameters [U].

    The state is built in the standardized u-space: real problems (with a
    prior table) use u_scale = init_scales and u_center = params0_free, so
    the initial u-space proposal covariance is the identity; analytic
    targets keep the identity map (their tests/benches address theta
    directly in physical units).
    """
    Df = problem.ndim_free
    x0 = problem.extract(problem.params0)
    # every state dtype follows the problem's parameter dtype: f32 is the
    # contract, f64 is the CPU validation mode (Problem.astype(jnp.float64)
    # under jax_enable_x64 — the whole carry must be one dtype or the scan
    # would reject its own output as a mismatched carry)
    dt = x0.dtype
    if init_scales is None:
        init_scales = default_init_scales(problem)
    phys_scales = np.asarray(init_scales, dtype=dt)
    if getattr(problem, "priors", None) is None:
        u_scale = np.ones(Df, dtype=dt)
        u_center = jnp.zeros_like(x0)
    else:
        u_scale = phys_scales
        u_center = x0
    scales = jnp.asarray(phys_scales / u_scale, dtype=dt)  # u-space
    u_scale = jnp.asarray(u_scale)
    k1, _ = jax.random.split(key)
    jit_noise = jitter * scales * jax.random.normal(k1, (n_temps, n_chains, Df),
                                                    dtype=dt)
    theta0 = jnp.broadcast_to((x0 - u_center) / u_scale,
                              (n_temps, n_chains, Df)) + jit_noise
    # ONE jitted call: eager dispatch would run the batched model eval
    # primitive by primitive; the data arrays are arguments (Problem.data)
    def _parts(data, u):
        (logL, logP), (gL, gP) = problem.with_data(
            data).batched_logparts_and_grad(u_center + u_scale * u)
        return (logL, logP), (gL * u_scale, gP * u_scale)
    (logL, logP), (gL, gP) = jax.jit(_parts)(problem.data(), theta0)
    TC = (n_temps, n_chains)
    cov0 = jnp.broadcast_to(jnp.diag(scales**2), TC + (Df, Df))
    chol0 = jnp.broadcast_to(jnp.diag(scales), TC + (Df, Df))
    ichol0 = (jnp.broadcast_to(jnp.diag(1.0 / scales), TC + (Df, Df))
              if hp.use_drift else jnp.zeros(TC + (Df, Df), dt))
    sigma0 = hp.sigma0_scale * 2.38 / np.sqrt(max(Df, 1))
    return SamplerState(
        theta=theta0, logL=logL, logP=logP, gradL=gL, gradP=gP,
        mu=jnp.broadcast_to((x0 - u_center) / u_scale, TC + (Df,)),
        cov=cov0, chol=chol0, ichol=ichol0,
        log_sigma=jnp.full(TC, float(np.log(sigma0)), dtype=dt),
        step=jnp.asarray(0, dtype=jnp.int32),
        naccept=jnp.zeros((n_temps,), dtype=dt),
        nprop=jnp.asarray(0.0, dtype=dt),
        acc_rate=jnp.full(TC, hp.resolved_target(), dtype=dt),
        nswap_att=jnp.zeros((n_temps,), dtype=dt),
        nswap_acc=jnp.zeros((n_temps,), dtype=dt),
        scales0=scales,
        u_center=u_center,
        u_scale=u_scale,
    )


def default_init_scales(problem) -> np.ndarray:
    """Per-free-parameter step scales from the prior table (or 0.1 for
    analytic targets without one)."""
    from tamcmc_tpu.stats.priors import PriorKind
    if getattr(problem, "priors", None) is None:
        return np.full(problem.ndim_free, 0.1)
    kinds = np.asarray(problem.priors.kinds)
    hyp = np.asarray(problem.priors.hypers)
    p0 = np.asarray(problem.params0)
    scales = np.maximum(np.abs(p0) * 0.01, 1e-6)
    for i in range(kinds.shape[0]):
        k = kinds[i]
        if k == int(PriorKind.GAUSSIAN):
            scales[i] = max(hyp[i, 1] * 0.1, 1e-8)
        elif k in (int(PriorKind.UNIFORM), int(PriorKind.UNIFORM_GAUSSIAN),
                   int(PriorKind.GUG)):
            scales[i] = max((hyp[i, 1] - hyp[i, 0]) * 0.01, 1e-8)
        elif k == int(PriorKind.JEFFREYS):
            scales[i] = max(hyp[i, 1] * 0.01, 1e-8)
    return scales[problem.free_idx]


def mala_step(problem: Problem, hp: MALAHyper, betas, state: SamplerState,
              key, adapt: bool = True, draws=None, axis_reduce=None):
    """One batched MALA(+adaptation) step for all (T, C) walkers.

    betas: (T,) inverse temperatures.  `adapt` is a static flag (phases
    compile separate variants — the reference freezes adaptation in the
    Acquire phase the same way).

    draws: optional (xi (T,C,Df) normal, u_acc (T,C) uniform) supplied by
    the caller instead of drawing from `key` — the explicit shard_map
    runner (parallel/shardmap_runner.py) draws with a MESH-INVARIANT
    per-walker key protocol so trajectories are bitwise mesh-shape-
    independent.  axis_reduce: optional fn(x, axis) replacing the
    cross-walker jnp.mean in the ensemble covariance estimator and the
    acceptance bookkeeping (a local-mean + pmean under shard_map).
    """
    T, C, Df = state.theta.shape
    if draws is None:
        k_prop, k_acc = jax.random.split(key)
    cmean = axis_reduce if axis_reduce is not None else \
        (lambda x, axis, keepdims=False:
         jnp.mean(x, axis=axis, keepdims=keepdims))
    sigma = jnp.exp(state.log_sigma)                       # (T, C)
    s2 = (sigma**2)[..., None]                              # (T, C, 1)
    b = betas[:, None]                                      # (T, 1)

    # --- forward proposal ---
    if hp.use_drift:
        g = b[..., None] * state.gradL + state.gradP        # tempered grad
        drift = _truncate_drift(g, hp.drift_delta)
        Sd = _matvec(state.cov, drift)
        mean_fwd = state.theta + 0.5 * s2 * Sd
    else:
        mean_fwd = state.theta
    xi = (jax.random.normal(k_prop, (T, C, Df), dtype=state.theta.dtype)
          if draws is None else draws[0])
    prop = mean_fwd + sigma[..., None] * _matvec(state.chol, xi)

    # --- evaluate proposal (model sees physical coordinates; gradients are
    # chain-ruled back into u-space: g_u = g_x * u_scale) ---
    prop_x = state.u_center + state.u_scale * prop
    if hp.use_drift:
        (logLp, logPp), (gLp, gPp) = problem.batched_logparts_and_grad(prop_x)
        gLp = gLp * state.u_scale
        gPp = gPp * state.u_scale
    else:
        # RW mode needs no gradients: skip the model backward pass entirely
        # (~3x cheaper step; the cached grad slots carry zeros)
        logLp, logPp = problem.batched_log_parts(prop_x)
        gLp = jnp.zeros_like(state.gradL)
        gPp = jnp.zeros_like(state.gradP)

    # --- reverse-proposal correction (vanishes when drift is off) ---
    if hp.use_drift:
        gp = b[..., None] * gLp + gPp
        drift_p = _truncate_drift(gp, hp.drift_delta)
        Sdp = _matvec(state.cov, drift_p)
        mean_rev = prop + 0.5 * s2 * Sdp
        r = _matvec(state.ichol, state.theta - mean_rev)
        logq_rev = -0.5 * jnp.sum(r**2, axis=-1) / sigma**2
        logq_fwd = -0.5 * jnp.sum(xi**2, axis=-1)
        q_corr = logq_rev - logq_fwd
    else:
        q_corr = 0.0

    # --- Metropolis-Hastings accept ---
    dlog = (b * (logLp - state.logL) + (logPp - state.logP) + q_corr)
    u_acc = (jax.random.uniform(k_acc, (T, C), dtype=dlog.dtype)
             if draws is None else draws[1])
    log_u = jnp.log(u_acc + 1e-38)
    accept = log_u < dlog                                   # (T, C)
    accf = accept.astype(state.theta.dtype)
    acc3 = accf[..., None]

    theta = jnp.where(acc3 > 0, prop, state.theta)
    logL = jnp.where(accept, logLp, state.logL)
    logP = jnp.where(accept, logPp, state.logP)
    gradL = jnp.where(acc3 > 0, gLp, state.gradL)
    gradP = jnp.where(acc3 > 0, gPp, state.gradP)

    inst_acc = jnp.minimum(jnp.exp(dlog), 1.0)              # (T, C)
    acc_rate = (1 - hp.acc_smooth) * state.acc_rate + hp.acc_smooth * inst_acc

    step = state.step + 1
    if adapt:
        k = step.astype(theta.dtype)
        gamma = hp.gain_c0 / (hp.gain_k0 + k) ** hp.gain_alpha
        if hp.resolved_cov_estimator(C, Df) == "ensemble":
            # pooled cross-walker moments per temperature: with C walkers in
            # the typical set this estimates the posterior covariance at
            # O(1/C) variance PER STEP — no trajectory-shrinkage feedback
            mean_c = cmean(theta, 1, keepdims=True)           # (T, 1, Df)
            mu = state.mu + gamma * (mean_c - state.mu)       # bcast (T,C,Df)
            dev = theta - mu
            emp = cmean(dev[..., :, None] * dev[..., None, :],
                        1, keepdims=True)                     # (T, 1, Df, Df)
            cov = state.cov + gamma * (emp - state.cov)
        else:
            # per-walker expanding-window moments (Haario-style 1/k gain:
            # full-history averages, no exponential forgetting — a fixed-ish
            # gain on a single trajectory self-shrinks: cov tracks short-time
            # increments, steps shrink, cov shrinks further)
            gm = 1.0 / jnp.maximum(k, 1.0)
            mu = state.mu + gm * (theta - state.mu)           # (T, C, Df)
            dev = theta - mu
            emp = dev[..., :, None] * dev[..., None, :]
            cov = state.cov + gm * (emp - state.cov)
        eye = jnp.eye(Df, dtype=cov.dtype)
        floor = hp.cov_floor * state.scales0**2               # (Df,)

        def refresh(cv):
            ch = jnp.linalg.cholesky(cv + jnp.diag(floor) + hp.eps_cov * eye)
            # SPD guard: if cholesky produced NaNs, keep the previous factor
            bad = jnp.any(jnp.isnan(ch), axis=(-2, -1), keepdims=True)
            ch = jnp.where(bad, state.chol, ch)
            # the reverse-kernel inverse refreshes WITH the factor (drift
            # mode only) — per-step work is then a plain matvec
            ich = _batched_tri_inverse(ch) if hp.use_drift \
                else state.ichol
            return ch, ich

        # Cholesky is latency-bound (sequential panels of tiny ops); refresh
        # the proposal factor only every dN_chol steps — mu/Sigma
        # keep adapting every step, the factor lags a few steps (harmless
        # under Robbins-Monro gains).
        chol, ichol = jax.lax.cond((step % hp.dN_chol) == 0, refresh,
                                   lambda cv: (state.chol, state.ichol), cov)
        # sigma update: expected acceptance (Rao-Blackwellised) or realized
        # 0/1 indicator (Atchade as written) — a documented parity switch,
        # see MALAHyper.sigma_acc_estimator / docs/PARITY.md.
        acc_est = inst_acc if hp.sigma_acc_estimator == "expected" else accf
        log_sigma = jnp.clip(
            state.log_sigma + gamma * (acc_est - hp.resolved_target()),
            hp.log_sigma_min, hp.log_sigma_max)
    else:
        mu, cov, chol, log_sigma = state.mu, state.cov, state.chol, state.log_sigma
        ichol = state.ichol

    return SamplerState(
        theta=theta, logL=logL, logP=logP, gradL=gradL, gradP=gradP,
        mu=mu, cov=cov, chol=chol, ichol=ichol, log_sigma=log_sigma, step=step,
        naccept=state.naccept + cmean(accf, 1),
        nprop=state.nprop + 1.0,
        acc_rate=acc_rate,
        nswap_att=state.nswap_att, nswap_acc=state.nswap_acc,
        scales0=state.scales0,
        u_center=state.u_center, u_scale=state.u_scale,
    )
