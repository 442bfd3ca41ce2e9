"""Rotational splitting of (l, m) mode frequencies.

Two parametrisations, matching the reference model families
(`function_rot.cpp` [U]; SURVEY.md section 2 "Rotation/splitting"):

  * a1etaa3: nu_nlm = nu_nl + m*a1 + eta0 * (a1 Hz)^2 * nu_nl * Q_lm + a3*P3(m)
      - a1      : mean rotational splitting [uHz]
      - eta0    : centrifugal distortion coefficient [s^2]
                  (see utils.constants.eta0_from_dnu)
      - Q_lm    = (l(l+1) - 3 m^2) / ((2l-1)(2l+3))   (quadrupole weight,
                  traceless: sum_m Q_lm = 0; Gough & Thompson 1990)
      - a3      : cubic latitudinal-differential-rotation coefficient [uHz]

  * aj: nu_nlm = nu_nl + sum_{j=1..6} a_j * P_j^{(l)}(m)
      with P_j the Ritzwoller & Lavely (1991) orthogonal polynomials in m,
      normalised so P_j^{(l)}(l) = l.  Computed exactly at trace time by
      Gram-Schmidt over the discrete grid m = -l..l (static per l, so this
      is host-side numpy — zero device cost).

XLA notes: splitting produces per-(mode, m) center frequencies as a static
(ncomp,) array feeding the dense Lorentzian contraction; everything is
differentiable in (a1, a3, ..., asphericity).
"""

import numpy as np
import jax
import jax.numpy as jnp


def rl_polynomials(l: int, jmax: int = 6) -> np.ndarray:
    """Ritzwoller-Lavely polynomials P_j^{(l)}(m) for j=1..jmax.

    Returns a float64 numpy array of shape (jmax, 2l+1) with rows j=1..jmax
    evaluated on m = -l..l.  Rows with j > 2l are zero (no such polynomial
    exists in the (2l+1)-dim space).  Exact discrete Gram-Schmidt with the
    convention P_j(l) = l; P_1(m) = m and
    P_2(m) = l*(3m^2 - l(l+1))/(3l^2 - l(l+1)) fall out as special cases.
    """
    m = np.arange(-l, l + 1, dtype=np.float64)
    basis = [np.ones_like(m)]
    for j in range(1, jmax + 1):
        if j > 2 * l:
            basis.append(np.zeros_like(m))
            continue
        v = m**j
        for b in basis:
            nb = np.dot(b, b)
            if nb > 0:
                v = v - (np.dot(v, b) / nb) * b
        basis.append(v)
    out = np.zeros((jmax, 2 * l + 1))
    for j in range(1, jmax + 1):
        v = basis[j]
        # normalise so P_j(m=l) = l  (standard a-coefficient convention)
        tail = v[-1]
        if abs(tail) > 0:
            out[j - 1] = v * (l / tail)
    return out


def qlm(l: int) -> np.ndarray:
    """Quadrupole asphericity weight Q_lm = (l(l+1) - 3m^2)/((2l-1)(2l+3)),
    shape (2l+1,), m = -l..l.  Q_00 = 0 by convention."""
    if l == 0:
        return np.zeros((1,))
    m = np.arange(-l, l + 1, dtype=np.float64)
    return (l * (l + 1) - 3.0 * m**2) / ((2 * l - 1) * (2 * l + 3))


def split_frequencies_a1etaa3(l: int, nu_nl, a1, eta0, a3):
    """Frequencies of the 2l+1 azimuthal components [uHz].

    nu_nl, a1, a3 in uHz; eta0 in s^2 (the a1 entering the centrifugal term
    is converted to Hz).  `a1` may be a scalar (one splitting for the ridge,
    the a1etaa3 family) or shaped like nu_nl (per-order splittings, the
    a1n/a1nl families).  Returns shape nu_nl.shape + (2l+1,).
    """
    m = jnp.asarray(np.arange(-l, l + 1), dtype=jnp.float32)
    q = jnp.asarray(qlm(l), dtype=jnp.float32)
    p3 = jnp.asarray(
        rl_polynomials(l, 3)[2] if l >= 2 else np.zeros(2 * l + 1),
        dtype=jnp.float32,
    )
    nu = jnp.asarray(nu_nl)[..., None]
    a1b = jnp.asarray(a1)[..., None]
    return nu + m * a1b + eta0 * (a1b * 1e-6) ** 2 * nu * q + a3 * p3


def split_frequencies_aj(l: int, nu_nl, aj_coeffs):
    """General a-coefficient splitting: nu + sum_j a_j P_j(m).

    aj_coeffs: shape (..., 6) — [a1..a6] in uHz (entries with j > 2l are
    ignored because the corresponding polynomial row is zero).
    Returns nu_nl.shape + (2l+1,).
    """
    polys = jnp.asarray(rl_polynomials(l, 6), dtype=jnp.float32)  # (6, 2l+1)
    nu = jnp.asarray(nu_nl)[..., None]
    # full f32: a TF32 product (GPU default) would quantise the splitting
    shift = jnp.einsum("...j,jm->...m", jnp.asarray(aj_coeffs), polys,
                       precision=jax.lax.Precision.HIGHEST)
    return nu + shift


def centrifugal_shift_aj(l: int, nu_nlm, eta0, a1):
    """Optional centrifugal term for the aj family (applied when the model's
    eta0 switch is on): eta0 * (a1 Hz)^2 * nu * Q_lm."""
    q = jnp.asarray(qlm(l), dtype=jnp.float32)
    return nu_nlm + eta0 * (a1 * 1e-6) ** 2 * nu_nlm * q
