"""Shared machinery for assembling mode sets into dense component arrays.

The MS-Global convention (reference `io_ms_global.cpp` / `models.cpp` [U]):
heights and widths are free parameters at the l=0 mode frequencies only;
l>0 modes take height/width *interpolated* (linearly in frequency) from the
l=0 profile, heights additionally scaled by the sampled visibility V^2_l, and
the (2l+1) azimuthal components are weighted by inclination visibilities and
split by the rotation law.

Design for XLA: component counts are static (ncomp = sum_l N_l*(2l+1)); assembly
produces flat (ncomp,) arrays feeding one dense Lorentzian contraction.
"""

from __future__ import annotations

import jax.numpy as jnp

from tamcmc_tpu.ops.visibilities import mode_visibility
from tamcmc_tpu.ops.rotation import (
    split_frequencies_a1etaa3, split_frequencies_aj, centrifugal_shift_aj,
)


def interp_monotonic(x, xp, fp):
    """Linear interpolation with edge clamping; differentiable in all args.

    jnp.interp requires sorted xp; mode frequencies are sorted by
    construction of the problem files.  Used for H(nu), W(nu) profiles.
    """
    return jnp.interp(x, xp, fp)


def assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                            visibilities, inc_rad, a1_per_l, eta0, a3, asym):
    """Build flat component arrays (H, C, W, B) under the a1-eta-a3 splitting
    with a per-degree splitting table.

    freqs_per_l: list indexed by l of (N_l,) frequency arrays (l = 0..lmax).
    visibilities: (lmax,) sampled V^2 for l=1..lmax.
    a1_per_l: list indexed by l; entry l is the a1 for that degree — a scalar
    (a1etaa3 / a1l families) or an (N_l,) per-order array (a1n / a1nl).
    Returns (heights, centers, widths, asyms) each (ncomp,).
    """
    f0 = freqs_per_l[0]
    hs, cs, ws, bs = [], [], [], []
    for l, fl in enumerate(freqs_per_l):
        if fl.shape[0] == 0:
            continue
        if l == 0:
            h_l, w_l = heights_l0, widths_l0
        else:
            h_l = interp_monotonic(fl, f0, heights_l0) * visibilities[l - 1]
            w_l = interp_monotonic(fl, f0, widths_l0)
        eps = mode_visibility(l, inc_rad)                      # (2l+1,)
        nus = split_frequencies_a1etaa3(l, fl, a1_per_l[l], eta0, a3)
        H = h_l[:, None] * eps[None, :]
        W = jnp.broadcast_to(w_l[:, None], nus.shape)
        B = jnp.broadcast_to(asym, nus.shape)
        hs.append(H.reshape(-1)); cs.append(nus.reshape(-1))
        ws.append(W.reshape(-1)); bs.append(B.reshape(-1))
    return (jnp.concatenate(hs), jnp.concatenate(cs),
            jnp.concatenate(ws), jnp.concatenate(bs))


def assemble_components_a1etaa3(freqs_per_l, heights_l0, widths_l0,
                                visibilities, inc_rad, a1, eta0, a3, asym):
    """a1etaa3 rotation law: one shared a1 for every degree (reference
    `model_MS_Global_a1etaa3_*` [U])."""
    return assemble_components_a1x(freqs_per_l, heights_l0, widths_l0,
                                   visibilities, inc_rad,
                                   [a1] * len(freqs_per_l), eta0, a3, asym)


def assemble_components_aj(freqs_per_l, heights_l0, widths_l0,
                           visibilities, inc_rad, aj, eta0, asym):
    """Same as above under the general a-coefficient law (a1..a6) with an
    optional centrifugal eta0 term (reference `model_MS_Global_aj_*` [U])."""
    f0 = freqs_per_l[0]
    hs, cs, ws, bs = [], [], [], []
    for l, fl in enumerate(freqs_per_l):
        if fl.shape[0] == 0:
            continue
        if l == 0:
            h_l, w_l = heights_l0, widths_l0
        else:
            h_l = interp_monotonic(fl, f0, heights_l0) * visibilities[l - 1]
            w_l = interp_monotonic(fl, f0, widths_l0)
        eps = mode_visibility(l, inc_rad)
        nus = split_frequencies_aj(l, fl, aj)
        nus = centrifugal_shift_aj(l, nus, eta0, aj[0])
        H = h_l[:, None] * eps[None, :]
        W = jnp.broadcast_to(w_l[:, None], nus.shape)
        B = jnp.broadcast_to(asym, nus.shape)
        hs.append(H.reshape(-1)); cs.append(nus.reshape(-1))
        ws.append(W.reshape(-1)); bs.append(B.reshape(-1))
    return (jnp.concatenate(hs), jnp.concatenate(cs),
            jnp.concatenate(ws), jnp.concatenate(bs))


def assemble_components_ajAlm(freqs_per_l, heights_l0, widths_l0,
                              visibilities, inc_rad, a1, a3, a5, eta0,
                              epsilon, theta0, delta, asym,
                              filter_kind: str = "gate"):
    """Odd a-coefficients (a1, a3, a5) + centrifugal eta0 + Alm activity
    shifts (reference `model_MS_Global_ajAlm_*` [U]): even asphericity is
    carried by the physical activity model instead of fitted a2/a4/a6."""
    from tamcmc_tpu.ops.alm import alm_shifts
    f0 = freqs_per_l[0]
    aj = jnp.stack([a1, jnp.zeros_like(a1), a3, jnp.zeros_like(a1),
                    a5, jnp.zeros_like(a1)])
    hs, cs, ws, bs = [], [], [], []
    for l, fl in enumerate(freqs_per_l):
        if fl.shape[0] == 0:
            continue
        if l == 0:
            h_l, w_l = heights_l0, widths_l0
        else:
            h_l = interp_monotonic(fl, f0, heights_l0) * visibilities[l - 1]
            w_l = interp_monotonic(fl, f0, widths_l0)
        eps = mode_visibility(l, inc_rad)
        nus = split_frequencies_aj(l, fl, aj)
        nus = centrifugal_shift_aj(l, nus, eta0, a1)
        if l > 0:
            nus = nus + alm_shifts(l, fl, epsilon, theta0, delta,
                                   kind=filter_kind)
        H = h_l[:, None] * eps[None, :]
        W = jnp.broadcast_to(w_l[:, None], nus.shape)
        B = jnp.broadcast_to(asym, nus.shape)
        hs.append(H.reshape(-1)); cs.append(nus.reshape(-1))
        ws.append(W.reshape(-1)); bs.append(B.reshape(-1))
    return (jnp.concatenate(hs), jnp.concatenate(cs),
            jnp.concatenate(ws), jnp.concatenate(bs))


def dnu_from_freqs(f0):
    """Mean large separation [uHz] from the l=0 ridge (differentiable);
    used for the eta0(Dnu) scaling when the model's eta switch is on."""
    if f0.shape[0] < 2:
        return jnp.asarray(100.0, dtype=f0.dtype)
    return (f0[-1] - f0[0]) / (f0.shape[0] - 1)
