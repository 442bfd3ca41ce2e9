"""Spectral likelihoods.

Reference equivalent: `likelihoods.cpp — likelihood_chi22p,
likelihood_chi_square`; name dispatch in `stats_dictionary.cpp` [U]
(SURVEY.md section 2 "Likelihoods").

chi^2 with 2 d.o.f. (raw periodogram, exponentially distributed bins):
    logL = -sum_i [ ln M_i + S_i / M_i ]
Gaussian chi^2 (averaged spectra with per-bin sigma):
    logL = -0.5 * sum_i ((S_i - M_i)/sigma_i)^2

XLA notes: this is THE hot reduction; it is kept as a pure jnp one-liner so
XLA fuses it with the model evaluation into a single kernel (SURVEY.md
section 2 called for exactly this fusion).  Reductions are chunked pairwise
by XLA (tree reduction), keeping f32 accumulation error ~sqrt(log N)*eps.
A `mask` lets callers restrict the fit window without dynamic shapes.
"""

import jax.numpy as jnp


def likelihood_chi22p(spec, model, mask=None):
    """chi^2(2 d.o.f.) log-likelihood of data `spec` under model spectrum
    `model` (same shape).  Model is floored at a tiny positive value to keep
    log/grad finite when a proposal wanders to zero power."""
    m = jnp.maximum(model, 1e-12)
    terms = jnp.log(m) + spec / m
    if mask is not None:
        terms = terms * mask
    return -jnp.sum(terms)


def likelihood_chi_square(spec, model, sigma, mask=None):
    """Gaussian log-likelihood for averaged spectra with per-bin sigma."""
    s = jnp.maximum(sigma, 1e-12)
    terms = ((spec - model) / s) ** 2
    if mask is not None:
        terms = terms * mask
    return -0.5 * jnp.sum(terms)


def likelihood_chi22p_pieces(spec, segments, bg_fn):
    """chi^2(2 d.o.f.) log-likelihood evaluated PIECE-WISE over a static
    window partition, without materialising the full model spectrum.

    segments: [(lo, hi, seg_values)] disjoint sorted bin ranges with the
    mode-sum evaluated on each (from a window-partitioned model, e.g.
    ms_global's `_segments_and_bg` hook); bg_fn(lo, hi) evaluates the
    background on bins [lo, hi) — PER PIECE, never on the full grid: a
    full-grid background sliced per piece would make each slice's VJP
    scatter-pad a (batch, N) cotangent per piece (measured 2x total step
    cost from backward copy traffic); evaluated per piece, the noise-param
    cotangents reduce within each piece to the tiny noise vector instead.
    Equivalent to likelihood_chi22p(spec, concat(pieces) + bg) up to f32
    reassociation, but (a) the (batch, N) concatenated spectrum is never
    written to memory, and (b) quiet-bin partial sums stay unbatched under
    vmap whenever the noise block is fully fixed — the piece-wise analog of
    the reference evaluating only inside truncation windows
    (`optimum_lorentzian_calc_*` [U])."""
    N = spec.shape[-1]
    total = 0.0
    pos = 0

    def quiet(lo, hi):
        m = jnp.maximum(bg_fn(lo, hi), 1e-12)
        return jnp.sum(jnp.log(m) + spec[lo:hi] / m, axis=-1)

    for lo, hi, seg in segments:
        # host-side invariant check (the bounds are static python ints):
        # raw OVERLAPPING groups from make_static_window_groups would
        # double-count overlap bins and miscount quiet gaps here — callers
        # must pass the disjoint sorted partition (partition_window_groups)
        if lo < pos or hi > N:
            raise ValueError(
                f"segment [{lo}, {hi}) violates the sorted-disjoint "
                f"partition invariant (previous end {pos}, grid size {N}); "
                "pass partition_window_groups output, not raw window groups")
        if lo > pos:
            total = total + quiet(pos, lo)
        m = jnp.maximum(seg + bg_fn(lo, hi), 1e-12)
        total = total + jnp.sum(jnp.log(m) + spec[lo:hi] / m, axis=-1)
        pos = hi
    if pos < N:
        total = total + quiet(pos, N)
    return -total


_REGISTRY = {
    "chi22p": likelihood_chi22p,
    "chi(2,2p)": likelihood_chi22p,      # reference spelling variant [U]
    "chi_square": likelihood_chi_square,
}


def get_likelihood(name: str):
    """Name -> function dispatch (resolved at trace time, never inside jit —
    replaces the reference's string dispatch in stats_dictionary.cpp [U])."""
    key = name.strip().lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown likelihood '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]
