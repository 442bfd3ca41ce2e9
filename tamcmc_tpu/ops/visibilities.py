"""Mode visibilities V^2(l, m, i): relative power of the (l, m) azimuthal
component of a mode observed at inclination i.

Closed forms are the squared associated-Legendre ratios

    eps_lm(i) = (l-|m|)! / (l+|m|)! * [P_l^{|m|}(cos i)]^2

(Gizon & Solanki 2003, eq. 10), normalised so sum_m eps_lm = 1 for every i.
Reference equivalent: `function_rot.cpp — amplitude_ratio` [U]
(SURVEY.md section 2, "Rotation/splitting & visibilities").

XLA notes: pure closed-form jnp; differentiable in i (inclination is a
sampled parameter); evaluated per-mode and broadcast over the frequency grid.
"""

import jax.numpy as jnp


def mode_visibility(l: int, inc_rad):
    """Return eps_lm(i) for m = -l..l as an array of shape (2l+1,).

    `l` is a static Python int (model structure is static under jit);
    `inc_rad` is a traced scalar (inclination in radians).
    """
    c = jnp.cos(inc_rad)
    s = jnp.sin(inc_rad)
    if l == 0:
        return jnp.ones((1,), dtype=jnp.result_type(inc_rad, jnp.float32))
    if l == 1:
        e0 = c**2
        e1 = 0.5 * s**2
        return jnp.stack([e1, e0, e1])
    if l == 2:
        e0 = 0.25 * (3.0 * c**2 - 1.0) ** 2
        # sin(2i)^2 = 4 c^2 s^2 — algebraic form, differentiable everywhere
        e1 = (3.0 / 8.0) * 4.0 * c**2 * s**2
        e2 = (3.0 / 8.0) * s**4
        return jnp.stack([e2, e1, e0, e1, e2])
    if l == 3:
        e0 = 0.25 * (5.0 * c**3 - 3.0 * c) ** 2
        e1 = (3.0 / 16.0) * (5.0 * c**2 - 1.0) ** 2 * s**2
        e2 = (15.0 / 8.0) * c**2 * s**4
        e3 = (5.0 / 16.0) * s**6
        return jnp.stack([e3, e2, e1, e0, e1, e2, e3])
    raise NotImplementedError(f"visibilities only implemented for l<=3, got l={l}")
