"""Analytic targets for sampler validation and benchmarking.

Plays the role the reference's `model_Test_Gaussian` plays for the C++
sampler (SURVEY.md section 4): a target with known posterior to validate the
MCMC machinery itself, without spectrum data in the loop.  Implements the
same protocol as `Problem` (ndim_free / extract / params0 /
batched_logparts_and_grad), so every sampler/driver/parallel code path is
exercised identically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

# a reference target: its products stay full f32 on every backend
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class AnalyticProblem:
    """logL = logpdf(x); logP = log_prior(x) (default 0)."""
    logpdf: Callable
    ndim: int
    x0: np.ndarray
    log_prior: Optional[Callable] = None

    @property
    def ndim_free(self):
        return int(self.ndim)

    @property
    def params0(self):
        return jnp.asarray(self.x0, dtype=jnp.float32)

    @property
    def free_idx(self):
        return np.arange(self.ndim)

    @property
    def free_names(self):
        return [f"x_{i}" for i in range(self.ndim)]

    def extract(self, full):
        return full

    def data(self) -> dict:
        return {}

    def with_data(self, data: dict) -> "AnalyticProblem":
        return self

    def embed(self, x):
        return x

    def log_parts(self, x):
        logL = self.logpdf(x)
        logP = self.log_prior(x) if self.log_prior is not None else jnp.asarray(0.0)
        return logL, jnp.broadcast_to(logP, jnp.shape(logL))

    def logparts_and_grad(self, x):
        (logL, logP), pull = jax.vjp(self.log_parts, x)
        gL, = pull((jnp.ones_like(logL), jnp.zeros_like(logP)))
        gP, = pull((jnp.zeros_like(logL), jnp.ones_like(logP)))
        return (logL, logP), (gL, gP)

    def batched_logparts_and_grad(self, x):
        return jax.vmap(jax.vmap(self.logparts_and_grad))(x)

    def batched_log_parts(self, x):
        return jax.vmap(jax.vmap(self.log_parts))(x)


def std_gaussian(ndim: int) -> AnalyticProblem:
    return AnalyticProblem(
        logpdf=lambda x: -0.5 * jnp.sum(x**2),
        ndim=ndim, x0=np.zeros(ndim))


def correlated_gaussian(cov: np.ndarray) -> AnalyticProblem:
    prec = np.linalg.inv(cov)
    P = jnp.asarray(prec, dtype=jnp.float32)
    d = cov.shape[0]
    return AnalyticProblem(
        logpdf=lambda x: -0.5 * jnp.dot(
            x, jnp.dot(P, x, precision=_HIGHEST), precision=_HIGHEST),
        ndim=d, x0=np.zeros(d))


def bimodal_1d(sep: float = 4.0) -> AnalyticProblem:
    """Two unit-variance modes at +-sep/2 — exercises tempering mixing."""
    def logpdf(x):
        a = -0.5 * (x[0] - sep / 2) ** 2
        b = -0.5 * (x[0] + sep / 2) ** 2
        return jnp.logaddexp(a, b) - jnp.log(2.0)
    return AnalyticProblem(logpdf=logpdf, ndim=1, x0=np.zeros(1))
