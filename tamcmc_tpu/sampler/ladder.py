"""Adaptive temperature-ladder tuning (beyond-reference, off by default).

The reference uses a FIXED geometric ladder T_k = lambda^k (`config.cpp`
lambda_temp [U]); badly matched ladders waste rungs (swap acceptance ~1)
or decouple them (~0).  This module implements Vousden, Farr & Mandel
(2016, MNRAS 455, 1919) dynamic temperature selection as a HOST-SIDE
between-chunk update during the Learning phase:

    S_k      = log(T_{k+1} - T_k)                 (k = 0..T-2)
    S_k     += gain * (A_k - A_{k+1})             (A_k = acceptance of the
                                                   rung-k/k+1 swap pair)
    T_{k+1}  = T_k + exp(S_k),   T_0 = 1 pinned   -> betas = 1/T

Equal pair acceptances are the fixed point (A_k > A_{k+1} pushes rung k+1
up, widening the gap below and narrowing it above).  The update runs on
the host between chunks — the ladder is a traced ARGUMENT of the phase
runner, so no recompile per update — and is FROZEN in Acquire (the chain
is only Markovian with a fixed kernel; adaptation during acquisition
would bias the posterior just like proposal adaptation would).

Enable with `tamcmc run --adapt-ladder` (MALAHyper.adapt_ladder).  A/B
against the static ladder: tools/ab_ladder.py (off by default: its earlier
A/B was inside estimator noise).
"""

from __future__ import annotations

import numpy as np


def pair_acceptance(att_delta, acc_delta):
    """Per-pair swap acceptance from CUMULATIVE counter deltas over a chunk.

    att/acc are (T,) arrays counting attempts/acceptances credited to the
    LOW rung of each pair (sampler/tempering.py); entry T-1 is always 0.
    Returns (T-1,) acceptance rates, 0.5 where a pair has no attempts yet
    (neutral: contributes no spacing push)."""
    att = np.asarray(att_delta, dtype=np.float64)[:-1]
    acc = np.asarray(acc_delta, dtype=np.float64)[:-1]
    out = np.full(att.shape, 0.5)
    has = att > 0
    out[has] = acc[has] / att[has]
    return out


def update_ladder(betas, att_delta, acc_delta, step_index: int,
                  gain0: float = 1.0, t0: float = 10.0):
    """One Vousden et al. between-chunk ladder update (host-side numpy).

    betas: (T,) descending inverse temperatures, betas[0] == 1 (pinned).
    step_index: 1-based count of ladder updates so far — the gain decays
    as gain0 * t0 / (t0 + step_index) (Vousden eq. 12's hyperbolic
    schedule), so the ladder is asymptotically frozen even inside Learning.
    Returns new (T,) betas, same dtype, cold rung untouched.
    """
    b = np.asarray(betas, dtype=np.float64)
    T = b.shape[0]
    if T < 3:
        return np.asarray(betas)     # nothing tunable: spacing is 1 number
    A = pair_acceptance(att_delta, acc_delta)          # (T-1,)
    temps = 1.0 / np.maximum(b, 1e-12)
    S = np.log(np.maximum(np.diff(temps), 1e-12))      # (T-1,)
    gain = gain0 * t0 / (t0 + max(step_index, 1))
    # only interior spacings move relative to each other; the last pair has
    # no A_{k+1} partner — Vousden holds the TOP temperature's dynamics to
    # the same equation with A_{T-1} only (its spacing grows while its own
    # acceptance exceeds the mean push from below)
    dS = np.empty_like(S)
    dS[:-1] = A[:-1] - A[1:]
    dS[-1] = 0.0                     # top spacing follows the others' drift
    S = S + gain * dS
    temps_new = np.concatenate([[1.0], 1.0 + np.cumsum(np.exp(S))])
    out = 1.0 / temps_new
    out[0] = 1.0
    return out.astype(np.asarray(betas).dtype)
