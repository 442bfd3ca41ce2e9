"""Sequential NumPy reference implementation — the measurable baseline proxy.

The C++ reference could not be built this round (empty mount — SURVEY.md
provenance note), and it publishes no benchmark numbers, so
bench.py anchors its `vs_baseline` ratio against this faithful architectural
emulation of the C++ sampler: ONE process, ONE walker per temperature,
temperatures stepped SEQUENTIALLY in a Python loop per iteration
(SURVEY.md section 3.1 — the serial chain loop), vectorised only across the
frequency grid (as Eigen vectorises the C++ model loop).  Adaptive RW
Metropolis (the reference's default operating mode) with the same
Robbins-Monro adaptation constants as the JAX sampler.

This is a *proxy*: when the real cpptamcmc becomes buildable its measured
throughput replaces this baseline.
"""

from __future__ import annotations

import numpy as np


class SequentialSampler:
    """plain-numpy adaptive Metropolis with parallel tempering."""

    def __init__(self, loglike, logprior, x0, scales, n_temps,
                 lambda_temp=1.5, target=0.234, gain_c0=1.0, gain_k0=10.0,
                 gain_alpha=0.6, dN_mixing=10, seed=0):
        self.loglike = loglike
        self.logprior = logprior
        D = x0.shape[0]
        self.D = D
        self.T = n_temps
        self.betas = 1.0 / lambda_temp ** np.arange(n_temps)
        self.rng = np.random.default_rng(seed)
        self.theta = np.tile(x0, (n_temps, 1)).astype(np.float64)
        self.logL = np.array([loglike(x0) for _ in range(n_temps)])
        self.logP = np.array([logprior(x0) for _ in range(n_temps)])
        self.mu = self.theta.copy()
        self.cov = np.stack([np.diag(scales**2)] * n_temps)
        self.chol = np.stack([np.diag(scales)] * n_temps)
        self.log_sigma = np.full(n_temps, np.log(2.38 / np.sqrt(D)))
        self.target = target
        self.gain = (gain_c0, gain_k0, gain_alpha)
        self.dN_mixing = dN_mixing
        self.k = 0
        self.naccept = np.zeros(n_temps)

    def step(self, adapt=True):
        self.k += 1
        c0, k0, alpha = self.gain
        gamma = c0 / (k0 + self.k) ** alpha
        for t in range(self.T):          # sequential chain loop, like the C++
            sigma = np.exp(self.log_sigma[t])
            prop = self.theta[t] + sigma * (self.chol[t] @
                                            self.rng.standard_normal(self.D))
            logLp = self.loglike(prop)
            logPp = self.logprior(prop)
            dlog = (self.betas[t] * (logLp - self.logL[t])
                    + (logPp - self.logP[t]))
            acc = np.log(self.rng.uniform() + 1e-300) < dlog
            if acc:
                self.theta[t] = prop
                self.logL[t] = logLp
                self.logP[t] = logPp
                self.naccept[t] += 1
            if adapt:
                self.mu[t] += gamma * (self.theta[t] - self.mu[t])
                dev = self.theta[t] - self.mu[t]
                self.cov[t] += gamma * (np.outer(dev, dev) - self.cov[t])
                try:
                    self.chol[t] = np.linalg.cholesky(
                        self.cov[t] + 1e-8 * np.eye(self.D))
                except np.linalg.LinAlgError:
                    pass
                self.log_sigma[t] = np.clip(
                    self.log_sigma[t]
                    + gamma * (min(np.exp(dlog), 1.0) - self.target),
                    -15.0, 4.0)
        if self.k % self.dN_mixing == 0:
            parity = (self.k // self.dN_mixing) % 2
            for i in range(parity, self.T - 1, 2):
                delta = ((self.betas[i] - self.betas[i + 1])
                         * (self.logL[i + 1] - self.logL[i]))
                if np.log(self.rng.uniform() + 1e-300) < delta:
                    for arr in (self.theta, self.logL, self.logP):
                        arr[[i, i + 1]] = arr[[i + 1, i]]
        return self.theta[0]
