"""Vectorised prior tables.

Reference equivalent: `priors_calc.cpp` — per-parameter prior kinds Uniform,
Gaussian, Jeffreys (modified, with knee), Uniform-Gaussian, Gaussian-Uniform-
Gaussian (GUG), Fix, Auto; family assemblers add cross-parameter constraints
[U] (SURVEY.md section 2 "Priors").

Redesign for XLA: instead of per-parameter string dispatch inside the hot
loop, the prior is compiled to a static table — an int kind-code and a (4,)
hyperparameter row per parameter — evaluated branch-free with `lax.switch`
under `vmap`.  Out-of-support returns a large negative constant (not -inf) so
gradients stay finite; the MH accept step rejects such proposals with
probability ~1.

Cross-parameter constraints (e.g. frequency ordering) are a per-model-family
hook: `extra_logp(params) -> scalar`, composed additively at problem build.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np
import jax
import jax.numpy as jnp

NEG_BIG = -1e30  # "minus infinity" that keeps autodiff finite
_SQRT2PI = float(np.sqrt(2.0 * np.pi))


class PriorKind(IntEnum):
    FIX = 0
    UNIFORM = 1
    GAUSSIAN = 2
    JEFFREYS = 3          # modified Jeffreys: p ~ 1/(x + h0) on [0, h1]
    UNIFORM_GAUSSIAN = 4  # flat on [h0,h1], Gaussian tail sigma=h2 above h1
    GUG = 5               # Gaussian(h2) below h0, flat [h0,h1], Gaussian(h3) above h1
    AUTO = 6              # hyperparameters derived at SETUP by
                          # stats/auto_priors.resolve_auto_priors (or the
                          # setup refuses loudly) — an AUTO code must never
                          # reach sampling; if one does, the free_mask
                          # excludes it and log_prior treats it as FIX


def _lp_fix(h, x):
    return jnp.zeros_like(x)


def _lp_uniform(h, x):
    lo, hi = h[0], h[1]
    inside = (x >= lo) & (x <= hi)
    lp = -jnp.log(jnp.maximum(hi - lo, 1e-30))
    return jnp.where(inside, lp, NEG_BIG)


def _lp_gaussian(h, x):
    mu, sig = h[0], jnp.maximum(h[1], 1e-30)
    return -0.5 * ((x - mu) / sig) ** 2 - jnp.log(sig * _SQRT2PI)


def _lp_jeffreys(h, x):
    """Modified Jeffreys with knee h0 on [0, h1]:
    p(x) = 1 / ((x + h0) * ln(1 + h1/h0))."""
    knee = jnp.maximum(h[0], 1e-30)
    hi = jnp.maximum(h[1], knee)
    inside = (x >= 0.0) & (x <= hi)
    norm = jnp.log1p(hi / knee)
    lp = -jnp.log(jnp.maximum(x + knee, 1e-30)) - jnp.log(norm)
    return jnp.where(inside, lp, NEG_BIG)


def _lp_uniform_gaussian(h, x):
    lo, hi, sig = h[0], h[1], jnp.maximum(h[2], 1e-30)
    Z = (hi - lo) + sig * _SQRT2PI / 2.0
    below = x < lo
    flat = (x >= lo) & (x <= hi)
    lp_flat = -jnp.log(jnp.maximum(Z, 1e-30))
    lp_tail = lp_flat - 0.5 * ((x - hi) / sig) ** 2
    return jnp.where(below, NEG_BIG, jnp.where(flat, lp_flat, lp_tail))


def _lp_gug(h, x):
    lo, hi = h[0], h[1]
    sig_lo = jnp.maximum(h[2], 1e-30)
    sig_hi = jnp.maximum(h[3], 1e-30)
    Z = (hi - lo) + (sig_lo + sig_hi) * _SQRT2PI / 2.0
    lp_flat = -jnp.log(jnp.maximum(Z, 1e-30))
    lp_lo = lp_flat - 0.5 * ((x - lo) / sig_lo) ** 2
    lp_hi = lp_flat - 0.5 * ((x - hi) / sig_hi) ** 2
    return jnp.where(x < lo, lp_lo, jnp.where(x > hi, lp_hi, lp_flat))


_BRANCHES = [_lp_fix, _lp_uniform, _lp_gaussian, _lp_jeffreys,
             _lp_uniform_gaussian, _lp_gug, _lp_fix]  # AUTO -> fix


def _logp_one(code, h, x):
    return jax.lax.switch(code, _BRANCHES, h, x)


@dataclasses.dataclass(frozen=True)
class PriorTable:
    """Static prior specification for a D-dim parameter vector.

    kinds: (D,) int array of PriorKind codes
    hypers: (D, 4) hyperparameter matrix
    names: optional parameter names (diagnostics/outputs)
    """
    kinds: np.ndarray
    hypers: np.ndarray
    names: tuple = ()

    def __post_init__(self):
        assert self.kinds.shape[0] == self.hypers.shape[0]
        assert self.hypers.shape[1] == 4

    @property
    def ndim(self):
        return int(self.kinds.shape[0])

    @property
    def free_mask(self) -> np.ndarray:
        return ~np.isin(np.asarray(self.kinds),
                        [int(PriorKind.FIX), int(PriorKind.AUTO)])

    def log_prior(self, params):
        """Total log-prior of a full parameter vector (jit/vmap/grad-safe)."""
        codes = jnp.asarray(np.asarray(self.kinds, dtype=np.int32))
        # kinds are always static (they gate the free mask / lax.switch), but
        # hypers may be a TRACED per-star batch in the aligned-grid ensemble
        # path (sampler/ensemble.py) — never force them through numpy.
        # dtype follows params so every lax.switch branch returns one dtype
        # (f32 contract; f64 under the --precision f64 validation mode).
        hyp = jnp.asarray(self.hypers, dtype=params.dtype)
        per = jax.vmap(_logp_one)(codes, hyp, params)
        # clamp so several out-of-support params don't overflow to -inf*k
        return jnp.maximum(jnp.sum(per), NEG_BIG)

    @staticmethod
    def from_rows(rows):
        """rows: iterable of (name, kind: PriorKind|str, [h0..h3]) tuples."""
        kinds, hypers, names = [], [], []
        for name, kind, *h in rows:
            if isinstance(kind, str):
                kind = PriorKind[kind.upper()]
            hh = list(h[0]) if h and isinstance(h[0], (list, tuple, np.ndarray)) else list(h)
            hh = (hh + [0.0] * 4)[:4]
            kinds.append(int(kind))
            hypers.append(hh)
            names.append(name)
        return PriorTable(np.asarray(kinds, dtype=np.int32),
                         np.asarray(hypers, dtype=np.float64).reshape(-1, 4),
                         tuple(names))
