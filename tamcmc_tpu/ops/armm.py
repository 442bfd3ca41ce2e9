"""ARMM — asymptotic mixed-mode solver for l=1 modes of evolved stars.

Reference equivalent: `external/ARMM/solver_mm.cpp`, `bump_DP.cpp` [U]
(SURVEY.md section 2 "Mixed-mode solver" — called the hardest model-side
port).  Physics: the p/g coupling eigenvalue condition (Unno et al.;
Mosser et al. 2012, A&A 540, A143)

    tan(theta_p) = q * tan(theta_g)
    theta_p = pi * (nu / Dnu - eps_p)
    theta_g = pi * (1e6 / (DPi1 * nu) - eps_g)      [nu in uHz, DPi1 in s]

Redesign of the root finding for static shapes: between any two consecutive poles of
either tangent, f(nu) = tan(theta_p) - q*tan(theta_g) is strictly increasing
(f' = pi/Dnu sec^2(theta_p) + q * pi*1e6/(DPi1 nu^2) sec^2(theta_g) > 0) and
sweeps -inf -> +inf, so each inter-pole interval holds EXACTLY one mixed
mode.  We therefore build static-size padded pole arrays (counts fixed by
the problem spec, positions traced), sort them, and run a fixed-iteration
vectorised bisection on every interval — no data-dependent shapes, no
while-loop convergence tests, fully differentiable in (Dnu, eps_p, DPi1,
eps_g, q) via implicit smoothness of the bisection limit.

zeta (the g-mode inertia fraction controlling width/splitting of each mixed
mode) follows Mosser et al. 2015 (A&A 584, A50) eq. 9:

    zeta = [1 + (nu^2 DPi1 / Dnu) * q / (q^2 cos^2(theta_g) + sin^2(theta_g))]^-1
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _theta_p(nu, dnu, eps_p, delta0l=0.0, alpha_p=0.0, nmax_x=0.0):
    """p-mode phase with the O(2) asymptotic relation (bump_DP depth [U]):

        theta_p = pi * (x - eps_p - delta0l/Dnu - alpha_p/2 (x - n_max)^2),
        x = nu / Dnu

    delta0l: small separation offsetting the l=1 p ridge from the l=0 comb
    (d01 [U]); alpha_p: curvature of the radial comb around n_max = the
    order at numax.  alpha_p = delta0l = 0 reduces to the first-order form.
    """
    x = nu / dnu
    return jnp.pi * (x - eps_p - delta0l / dnu
                     - 0.5 * alpha_p * (x - nmax_x) ** 2)


def _theta_g(nu, dpi1, eps_g, alpha_g=0.0, pi0_x=0.0):
    """g-mode phase with optional period-spacing curvature [U]:

        theta_g = pi * (y - eps_g - alpha_g/2 (y - y0)^2),
        y = Pi(nu)/DPi1 = 1e6 / (DPi1 * nu)

    y0 = reference period index (window centre).  alpha_g = 0 reduces to the
    uniform-DPi1 relation (Mosser 2012); the curvature term mirrors the
    p-side O(2) form — RE-GROUND the exact parameterisation against
    bump_DP.cpp when the reference mount is readable.
    """
    y = 1e6 / (dpi1 * nu)
    return jnp.pi * (y - eps_g - 0.5 * alpha_g * (y - pi0_x) ** 2)


def _f(nu, dnu, eps_p, dpi1, eps_g, q, delta0l=0.0, alpha_p=0.0,
       nmax_x=0.0, alpha_g=0.0, pi0_x=0.0):
    return (jnp.tan(_theta_p(nu, dnu, eps_p, delta0l, alpha_p, nmax_x))
            - q * jnp.tan(_theta_g(nu, dpi1, eps_g, alpha_g, pi0_x)))


def mixed_mode_frequencies(dnu, eps_p, dpi1, eps_g, q, numin, numax,
                           n_p_poles: int, n_g_poles: int, n_bisect: int = 45,
                           delta0l=0.0, alpha_p=0.0, alpha_g=0.0):
    """Solve for all l=1 mixed-mode frequencies in [numin, numax].

    dnu [uHz], dpi1 [s], q, eps_p, eps_g: traced scalars.  The O(2) terms
    (delta0l [uHz], alpha_p, alpha_g — see _theta_p/_theta_g) default to 0,
    reproducing the first-order solver exactly.
    numin/numax: static floats.  n_p_poles / n_g_poles: static ints — upper
    bounds on pole counts in the window (size the padding generously; out-of-
    window poles are clamped and their intervals masked out).

    Returns (freqs, zeta, valid): arrays of shape (n_p_poles + n_g_poles - 1,).
    Invalid (padded) slots have freq = numax and valid = 0.
    """
    nmax_x = 0.5 * (numin + numax) / dnu            # curvature pivot (order)
    pi0_x = 1e6 / (dpi1 * (0.5 * (numin + numax)))  # curvature pivot (period)

    # p-mode tangent poles: theta_p = pi (k + 1/2).  With curvature the pole
    # equation is quadratic in x; 3 fixed-point sweeps from the linear pole
    # converge to float32 precision for |alpha_p| << 1 (the physical regime).
    k0p = jnp.floor(numin / dnu - 0.5 - eps_p - delta0l / dnu)
    kp = k0p + jnp.arange(n_p_poles, dtype=jnp.float32)
    xp = kp + 0.5 + eps_p + delta0l / dnu
    for _ in range(3):
        xp = kp + 0.5 + eps_p + delta0l / dnu + 0.5 * alpha_p * (xp - nmax_x) ** 2
    p_poles = dnu * xp
    # g-mode tangent poles: theta_g = pi (k + 1/2), same fixed-point in y.
    k0g = jnp.floor(1e6 / (dpi1 * numax) - 0.5 - eps_g)
    kg = k0g + jnp.arange(n_g_poles, dtype=jnp.float32)
    yg = kg + 0.5 + eps_g
    for _ in range(3):
        yg = kg + 0.5 + eps_g + 0.5 * alpha_g * (yg - pi0_x) ** 2
    g_poles = 1e6 / (dpi1 * yg)

    poles = jnp.concatenate([p_poles, g_poles])
    poles = jnp.clip(poles, numin, numax)
    poles = jnp.sort(poles)

    a = poles[:-1]
    b = poles[1:]
    width = b - a
    valid = width > 1e-4                     # collapsed (clamped) intervals out
    eps = jnp.maximum(width * 1e-3, 1e-6)
    lo = a + eps
    hi = b - eps

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        fm = _f(mid, dnu, eps_p, dpi1, eps_g, q,
                delta0l, alpha_p, nmax_x, alpha_g, pi0_x)
        pos = fm > 0
        return (jnp.where(pos, lo, mid), jnp.where(pos, mid, hi))

    lo, hi = jax.lax.fori_loop(0, n_bisect, body, (lo, hi))
    freqs = 0.5 * (lo + hi)

    # window-edge intervals are truncated by the clamp and need not bracket a
    # real root (bisection then converges to the boundary) — validate every
    # root against the well-conditioned phase form of the eigenvalue equation
    tp_r = _theta_p(freqs, dnu, eps_p, delta0l, alpha_p, nmax_x)
    tg_r = _theta_g(freqs, dpi1, eps_g, alpha_g, pi0_x)
    phase_res = jnp.mod(tp_r - jnp.arctan(q * jnp.tan(tg_r)) + jnp.pi / 2,
                        jnp.pi) - jnp.pi / 2
    valid = valid & (jnp.abs(phase_res) < 0.05)

    tg = tg_r
    denom = q**2 * jnp.cos(tg) ** 2 + jnp.sin(tg) ** 2
    # units: nu_Hz^2 * DPi1_s / Dnu_Hz = nu_uHz^2 * 1e-6 * DPi1 / Dnu_uHz
    zeta = 1.0 / (1.0 + (freqs**2 * 1e-6) * dpi1 / dnu
                  * q / jnp.maximum(denom, 1e-12))

    freqs = jnp.where(valid, freqs, numax)
    zeta = jnp.where(valid, zeta, 0.0)
    return freqs, zeta, valid.astype(freqs.dtype)


def count_poles(dnu, dpi1, eps_p, eps_g, numin, numax, margin: int = 4):
    """Host-side helper: static pole-count bounds for a problem window given
    *reference values* of (dnu, dpi1) — size with `margin` slack so the
    traced values can wander under the prior without overflowing the pads."""
    import math
    n_p = int(math.ceil((numax - numin) / dnu)) + margin
    n_g = int(math.ceil(1e6 / dpi1 * (1.0 / numin - 1.0 / numax))) + margin
    return n_p, n_g
