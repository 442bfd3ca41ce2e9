"""Effective sample size via integrated autocorrelation time.

The headline throughput metric of the rebuild is effective-samples/s/chip
(PERF.md); the reference has no equivalent (console acceptance prints
only — SURVEY.md section 5.1).  Host-side numpy: runs on thinned chains after
device_get, never in the hot path.

Method: the MULTI-CHAIN estimator of Vehtari et al. (2021) / Stan: per-walker
FFT autocovariances are combined with the BETWEEN-walker variance,
rho_t = 1 - (W_mean - mean_acov_t) / var_plus, then Geyer
initial-positive-sequence truncation; ESS = N*W / tau.

The between-chain term is load-bearing, not a nicety: a per-walker-only
estimator (the original implementation here) reports a huge ESS for walkers
that are each frozen in place at DIFFERENT points — tiny within-walker
autocorrelation, zero actual sampling.  Including B makes rho ~ 1 in that
regime, tau ~ N, and ESS collapses to ~W, which is the honest answer.
"""

from __future__ import annotations

import numpy as np


def _acov_1d(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) autocovariance via FFT; shape (n,)."""
    n = x.shape[0]
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def autocorr_time(chain: np.ndarray) -> float:
    """chain: (N,) or (N, W) samples (W walkers of one posterior).
    Returns the multi-chain integrated autocorrelation time tau (>= 1).

    Input is cast to float64 FIRST.  Round-5 diagnosis: numpy's axis-0
    reductions over large C-contiguous f32 arrays can accumulate with
    f32 intermediate error — measured ~1.7 uHz (2 posterior sigma) of
    MEAN bias and a 2.2x STD inflation on a 96000-row flat array of
    ~2300 uHz frequencies (tools/golden_flagship.py's first golden).  At
    this function's (N, W) walker shapes the measured effect is
    negligible (ESS 2174.05 in both precisions on the same data), so the
    cast here is cheap insurance for larger inputs, not a bug fix."""
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim == 1:
        chain = chain[:, None]
    n, w = chain.shape
    if n < 4:
        return 1.0
    acovs = np.stack([_acov_1d(chain[:, j]) for j in range(w)])   # (W, N)
    # within-chain variance (unbiased) and between-chain variance of means
    Wvar = float(np.mean(acovs[:, 0]) * n / (n - 1))
    if Wvar <= 0:
        return 1.0
    if w > 1:
        Bvar = float(np.var(chain.mean(axis=0), ddof=1))
    else:
        Bvar = 0.0
    var_plus = Wvar * (n - 1) / n + Bvar
    rho = 1.0 - (Wvar - np.mean(acovs, axis=0)) / var_plus      # (N,)
    # Geyer (1992) initial positive sequence: tau = 2*sum(Gamma_m) - 1 with
    # Gamma_m = rho[2m] + rho[2m+1], truncated at the first Gamma_m <= 0.
    npair = n // 2
    gam = rho[0:2 * npair:2] + rho[1:2 * npair:2]
    s = 0.0
    for g in gam:
        if g <= 0:
            break
        s += g
    return max(float(2.0 * s - 1.0), 1.0)


def effective_sample_size(chain: np.ndarray) -> float:
    """chain: (N,) or (N, W). ESS = N*W / tau (multi-chain tau)."""
    if chain.ndim == 1:
        chain = chain[:, None]
    n, w = chain.shape
    return n * w / autocorr_time(chain)


def _split_rhat_raw(chain: np.ndarray) -> float:
    """Plain split-R-hat (Gelman et al.) on (N, W) draws: each walker is
    split in half -> 2W sub-chains of length N//2; R = sqrt(var_plus/W)."""
    n, w = chain.shape
    half = n // 2
    if half < 2:
        return float("nan")
    sub = np.concatenate([chain[:half], chain[n - half:]], axis=1)  # (half, 2W)
    means = sub.mean(axis=0)
    Bvar = half * np.var(means, ddof=1)
    Wvar = float(np.mean(np.var(sub, axis=0, ddof=1)))
    if Wvar <= 0:
        # all sub-chains frozen: identical points -> converged-degenerate
        # (R=1) if the means agree, diverged (inf) if they don't
        return 1.0 if Bvar <= 0 else float("inf")
    var_plus = (half - 1) / half * Wvar + Bvar / half
    return float(np.sqrt(var_plus / Wvar))


def split_rhat(chain: np.ndarray) -> float:
    """Rank-normalized split-R-hat (Vehtari et al. 2021).

    chain: (N,) or (N, W) posterior draws of ONE parameter across W walkers.
    The reference has no automated convergence statistic (plots are eyeballed
    — SURVEY.md section 4); this is the companion-tools-grade check
    (TAMCMC-tools [U]) run on thinned host-side chains: R-hat <= 1.01 is the
    standard convergence bar.  Rank-normalizing first (inverse-normal of the
    pooled ranks) makes the statistic robust to heavy tails; we report the
    max of the rank-normalized R on the draws and on the folded draws
    |x - median| (the latter catches scale disagreement that the
    location-only statistic misses)."""
    from scipy.special import ndtri

    if chain.ndim == 1:
        chain = chain[:, None]
    n, w = chain.shape
    if n < 4:
        return float("nan")

    def ranknorm(x):
        flat = x.reshape(-1)
        r = np.argsort(np.argsort(flat)) + 1.0          # ranks 1..S
        z = ndtri((r - 3.0 / 8.0) / (flat.size + 0.25))
        return z.reshape(x.shape)

    bulk = _split_rhat_raw(ranknorm(chain))
    folded = _split_rhat_raw(ranknorm(np.abs(chain - np.median(chain))))
    return max(bulk, folded)
